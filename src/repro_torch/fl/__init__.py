from repro_torch.fl.aggregator import AggregationExecutor  # noqa: F401
from repro_torch.fl.fusion import (  # noqa: F401
    ALGORITHMS,
    FedAvg,
    FedProx,
    FedSGD,
    FusionState,
    get_algorithm,
)
from repro_torch.fl.job import FLJobRuntime, RoundRecord  # noqa: F401
from repro_torch.fl.party import LocalResult, Party  # noqa: F401
