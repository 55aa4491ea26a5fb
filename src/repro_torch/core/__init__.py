"""Framework-neutral scheduling half of the system (pure Python + numpy):
job specs, arrival prediction, t_agg estimation, the discrete-event core,
the simulated cluster, the message queue, §6.2 metrics and the strategy
registry with its ``RoundEngine``."""
from repro_torch.core.estimator import (  # noqa: F401
    AggregationEstimator,
    AggregatorResources,
    usable_cores,
)
from repro_torch.core.events import Simulator  # noqa: F401
from repro_torch.core.cluster import Cluster, ClusterConfig  # noqa: F401
from repro_torch.core.jobspec import FLJobSpec, PartySpec  # noqa: F401
from repro_torch.core.metrics import JobMetrics  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    FIXED_JIT_POLICY,
    PolicyConfig,
    as_replay_policy,
    available_strategies,
    register_strategy,
)
from repro_torch.core.queue import MessageQueue  # noqa: F401
from repro_torch.core.strategies import (  # noqa: F401
    MeasuredArrivals,
    RoundEngine,
)
