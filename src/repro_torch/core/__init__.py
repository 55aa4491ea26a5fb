"""The paper's primary contribution: just-in-time aggregation scheduling.

  jobspec     — FL job + party specifications (§5.1/§5.2)
  prediction  — periodicity/linearity update-arrival prediction (§4, §5.3)
  estimator   — t_pair measurement + t_agg estimation (§5.4)
  scheduler   — Fig. 6 JIT scheduler: timers + priorities + preemption (§5.5)
  policy      — PolicyConfig + AggregationStrategy protocol + registry
  strategies  — RoundEngine + eager-AO / eager-λ / batched / lazy / JIT (§3)
  events      — discrete-event simulation core
  cluster     — simulated k8s cluster with overheads + preemption
  queue       — durable message queue (Kafka/object-store stand-in)
  metrics     — aggregation latency, container-seconds, projected cost (§6.2)
"""
from repro_torch.core.estimator import (  # noqa: F401
    AggregationEstimator,
    AggregatorResources,
    measure_t_pair,
    usable_cores,
)
from repro_torch.core.events import Simulator  # noqa: F401
from repro_torch.core.cluster import Cluster, ClusterConfig  # noqa: F401
from repro_torch.core.jobspec import FLJobSpec, PartySpec  # noqa: F401
from repro_torch.core.metrics import (  # noqa: F401
    FleetMetrics,
    JobMetrics,
    aggregation_latency,
    fleet_rollup,
    savings,
    sla_lateness,
)
from repro_torch.core.prediction import (  # noqa: F401
    LinearEstimator,
    PeriodicTracker,
    UpdatePredictor,
)
from repro_torch.core.policy import (  # noqa: F401
    FIXED_JIT_POLICY,
    AggregationStrategy,
    PolicyConfig,
    as_replay_policy,
    available_strategies,
    get_strategy,
    register_strategy,
)
from repro_torch.core.queue import MessageQueue  # noqa: F401
from repro_torch.core.scheduler import JITScheduler  # noqa: F401
from repro_torch.core.strategies import (  # noqa: F401
    STRATEGIES,
    ArrivalModel,
    ArrivalSource,
    MeasuredArrivals,
    RoundEngine,
    StrategyRun,
    run_strategy,
)
