from repro_torch.models.model import (  # noqa: F401
    forward,
    init,
    loss_fn,
    n_params,
    param_specs,
)
from repro_torch.models.spec import (  # noqa: F401
    TensorSpec,
    count_params,
    init_params,
)
