"""Pluggable aggregation-policy API: the declarative ``PolicyConfig``, the
``AggregationStrategy`` plugin protocol and the strategy registry.

Mirrors the ``configs.base.register`` idiom: deployment strategies
self-register under a name with ``@register_strategy("name")``, the round
engine resolves them by name at construction, and the public ``STRATEGIES``
tuple is derived from the registry instead of hard-coded. Adding a new
deployment policy (adaptive, serverless-tiered, ...) is a plugin — a
subclass receiving engine callbacks — not a fork of the engine.

Adaptive Aggregation (Jayaram et al., 2022) and LIFL (Qi et al., 2024)
both motivate swappable event-driven aggregation policies; this module is
the seam that makes them ~100-line additions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Tuple, Type

JIT_POLICIES = ("orderstat", "paper", "fixed")


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Declarative deployment-policy configuration, validated on construction.

    Replaces the former kwarg sprawl of ``run_strategy``/``StrategyRun``.
    Only the knobs relevant to the selected strategy are read by it; the
    others are inert (e.g. ``batch_trigger`` under ``strategy="jit"``).

    Knobs:
      strategy                  registry name of the deployment strategy
      batch_trigger             batched-λ: updates per deployment (§3)
      jit_policy                "paper" = Fig. 6 literal timer;
                                "orderstat" = order-statistic t_rnd +
                                backlog-fill trigger (beyond-paper default);
                                "fixed" = fully deterministic timeline:
                                deploy exactly at t_rnd − t_agg, stay hot
                                until the round completes, calibrate the
                                estimator online (the real-training
                                vehicle's replay default)
      margin_sigmas             orderstat safety margin: the expected last
                                arrival is pushed ``margin_sigmas`` standard
                                deviations of the max order statistic later
                                (0 = mean estimate; larger = later deploys,
                                capped at the t_wait window boundary)
      keepalive_factor          stay hot while expected remaining makespan
                                <= factor * stragglers * redeploy cycle (§5.5)
      amort_factor              opportunistic early drain once pending fuse
                                work >= factor * redeploy cycle
      eager_max_per_invocation  eager-λ: max updates folded into one
                                serverless invocation
      opportunistic             allow early drains on idle cluster capacity
    """

    strategy: str = "jit"
    batch_trigger: int = 10
    jit_policy: str = "orderstat"
    margin_sigmas: float = 0.0
    keepalive_factor: float = 1.0
    amort_factor: float = 4.0
    eager_max_per_invocation: int = 32
    opportunistic: bool = False

    def __post_init__(self):
        if not isinstance(self.strategy, str) or not self.strategy:
            raise ValueError("PolicyConfig.strategy must be a non-empty name")
        if self.batch_trigger < 1:
            raise ValueError(
                f"batch_trigger must be >= 1, got {self.batch_trigger}")
        if self.jit_policy not in JIT_POLICIES:
            raise ValueError(
                f"jit_policy must be one of {JIT_POLICIES}, "
                f"got {self.jit_policy!r}")
        if self.margin_sigmas < 0.0:
            raise ValueError(
                f"margin_sigmas must be >= 0, got {self.margin_sigmas}")
        if self.keepalive_factor < 0.0:
            raise ValueError(
                f"keepalive_factor must be >= 0, got {self.keepalive_factor}")
        if self.amort_factor <= 0.0:
            raise ValueError(
                f"amort_factor must be > 0, got {self.amort_factor}")
        if self.eager_max_per_invocation < 1:
            raise ValueError(
                f"eager_max_per_invocation must be >= 1, "
                f"got {self.eager_max_per_invocation}")

    def replace(self, **over) -> "PolicyConfig":
        return dataclasses.replace(self, **over)


#: The real-training replay default: the deterministic JIT timeline
#: (deploy exactly at t_rnd − t_agg, container hot through completion,
#: estimator calibrated online) that ``FLJobRuntime`` has always priced.
FIXED_JIT_POLICY = PolicyConfig(strategy="jit", jit_policy="fixed")


def as_policy(policy) -> PolicyConfig:
    """Coerce None / a strategy name / a PolicyConfig into a PolicyConfig."""
    if policy is None:
        return PolicyConfig()
    if isinstance(policy, str):
        return PolicyConfig(strategy=policy)
    if isinstance(policy, PolicyConfig):
        return policy
    raise TypeError(
        f"policy must be a strategy name or PolicyConfig, got {type(policy)}")


def as_replay_policy(policy) -> PolicyConfig:
    """``as_policy`` for the real-training / measured-replay vehicles:
    None and the bare name "jit" both resolve to the deterministic
    ``FIXED_JIT_POLICY`` (the vehicles' regression-locked default), so a
    loop over strategy NAMES prices the same jit timeline the vehicle
    reports by default. An explicit ``PolicyConfig`` is honoured as-is —
    ``PolicyConfig(strategy="jit")`` still selects the orderstat
    simulation policy."""
    if policy is None or policy == "jit":
        return FIXED_JIT_POLICY
    return as_policy(policy)


class AggregationStrategy:
    """Base class for deployment-strategy plugins.

    A strategy owns the *when to deploy* decisions of one FL job; the
    ``RoundEngine`` owns everything shared — arrival scheduling, round
    windows, quorum, metrics and the streaming-container / serverless-task
    mechanics. The engine calls the hooks below; strategies act through the
    engine's callback surface (``submit_batch``, ``take_pending``,
    ``stream_deploy``/``stream_feed``/``stream_release``, ``all_arrived``,
    ``expected_remaining_makespan``, ``task_done``).

    All hooks are optional; the defaults are no-ops, and ``finish_round``
    releases a live streaming container before timestamping completion.
    """

    name: ClassVar[str] = "?"

    def __init__(self, engine, policy: PolicyConfig):
        self.engine = engine
        self.policy = policy

    # ---- job lifecycle -----------------------------------------------------
    def on_job_start(self) -> None:
        """Before the first round (e.g. deploy an always-on container)."""

    def on_job_end(self) -> None:
        """After the last round (e.g. shut the always-on container down)."""

    # ---- round lifecycle ---------------------------------------------------
    def on_round_reset(self) -> None:
        """Clear per-round strategy state (called before every round)."""

    def on_round_start(self) -> None:
        """Arrivals and the t_wait window are scheduled; plan deployments."""

    def on_update(self) -> None:
        """An update was appended to ``engine.pending``."""

    def on_window_close(self) -> None:
        """t_wait hit with work remaining: drain what arrived now (§4.3)."""

    def on_task_done(self) -> None:
        """A processing task finished and the round is not complete."""

    def finish_round(self) -> float:
        """The round's last update was processed; return completion time."""
        e = self.engine
        if e.stream_deployed:
            return e.stream_release()
        return e.sim.now  # serverless-task checkpoint billed by the Cluster

    def on_round_end(self) -> None:
        """Round completed; cancel strategy-owned timers."""

    def accrued_container_seconds(self) -> float:
        """Container time the strategy has accrued but not yet billed to
        the cluster. Long-lived containers (the always-on aggregator) bill
        only at shutdown, so a run stopped mid-job would otherwise report
        zero billing for them; ``RoundEngine.billed_metrics`` folds this in
        so partial runs (``Platform.run(until=...)``) price what was
        actually consumed. Zero once the job completes (everything billed)
        and for strategies whose tasks bill at completion."""
        return 0.0


StrategyFactory = Callable[..., AggregationStrategy]
_REGISTRY: Dict[str, Type[AggregationStrategy]] = {}


def register_strategy(name: str):
    """Class decorator registering an ``AggregationStrategy`` under `name`."""

    def deco(cls: Type[AggregationStrategy]) -> Type[AggregationStrategy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtins() -> None:
    if "jit" not in _REGISTRY:  # built-ins register at import time
        from repro_torch.core import strategies as _s  # noqa: F401


def get_strategy(name: str) -> Type[AggregationStrategy]:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregation strategy {name!r}; available: "
            f"{sorted(_REGISTRY)}. Register new strategies with "
            f"@register_strategy({name!r})."
        ) from None


def available_strategies() -> Tuple[str, ...]:
    """Registered strategy names, built-ins first (registration order)."""
    _ensure_builtins()
    return tuple(_REGISTRY)
