from repro_torch.data.loader import Loader  # noqa: F401
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_domain_mixes,
    partition_indices,
    party_sizes,
)
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: F401
