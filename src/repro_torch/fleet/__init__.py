"""``repro.fleet`` — trace-driven multi-job workload simulation.

  traces       — WorkloadTrace/JobTrace/PartyPattern model (JSON-lines),
                 synthetic fleet generators, measured-run exporters
  parties      — SimulatedParty availability processes + engine adapter
  fleet        — FleetRunner: a trace over one shared cluster, per-job
                 JobMetrics + fleet-level rollups
  conformance  — cross-vehicle conformance harness: the (strategy ×
                 pattern × capacity tier) scenario matrix, checked for
                 arrival parity, Fig. 9 savings and §6.2 latency bands

Entry point: ``repro.api.Platform.submit_fleet(trace, strategy=...)``.
"""
from repro_torch.fleet.conformance import (  # noqa: F401
    CAPACITY_TIERS,
    CONFORMANCE_PATTERNS,
    CONFORMANCE_STRATEGIES,
    CellReport,
    CellSpec,
    default_matrix,
    long_horizon_matrix,
    run_cell,
    run_matrix,
)
from repro_torch.fleet.fleet import FleetResult, FleetRunner  # noqa: F401
from repro_torch.fleet.parties import (  # noqa: F401
    ArrivalRecorder,
    FleetArrivalSource,
    MeasuredParty,
    SimulatedParty,
    build_parties,
)
from repro_torch.fleet.traces import (  # noqa: F401
    JOB_MIX,
    MIXED_PATTERNS,
    PATTERNS,
    JobClass,
    JobTrace,
    PartyPattern,
    WorkloadTrace,
    fleet_from_measured,
    make_pattern,
    synthetic_fleet,
    trace_from_measured,
)
