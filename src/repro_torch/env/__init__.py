"""repro_torch.env — the environment engine: composable cluster scenarios
compiled for the serving loops.

A scenario is a declarative composition of pure processes of time —
arrivals λ(t), capacity μ(t), membership (worker churn), faults —
compiled to per-turn arrays that drive the host serving loop
(``env.run_workload``) and the one-program loop
(``serving/scanloop.run_workload_scan``). See ``env/scenario.py`` for the
model and ``env/processes.py`` for the process library.

    from repro_torch import env
    scn = env.make("flash_crowd")
    out = env.run_scenario(scn, policy="ppot_sq2", use_scan=True)

Catalog: ``env.names()`` — null, reshuffle, flash_crowd, diurnal,
cotenant_shock, speed_drift, churn, churn_heavy, trace_replay,
crash_storm, blackout, grey_failure. Fault scenarios compile; running
them waits for the failure semantics (ROADMAP queue A, A4).
"""
from repro_torch.env.processes import (
    FAULT_BLACKOUT,
    FAULT_CRASH,
    PROBE_BURST,
    ChurnSchedule,
    Diurnal,
    FaultSchedule,
    HomogeneousPoisson,
    MMPP,
    OnOffInterference,
    OUDrift,
    PiecewiseRate,
    RandomChurn,
    RandomFaults,
    Reshuffle,
    StaticCapacity,
    StepSchedule,
    TraceArrivals,
    synthesize_tpch_trace,
)
from repro_torch.env.scenario import (
    BASE_RATE,
    BASE_SPEEDS,
    SCENARIOS,
    Scenario,
    ServingWorkload,
    make,
    names,
    register,
)
from repro_torch.env.serving import run_scenario, run_workload

__all__ = [
    "BASE_RATE",
    "BASE_SPEEDS",
    "FAULT_BLACKOUT",
    "FAULT_CRASH",
    "PROBE_BURST",
    "SCENARIOS",
    "ChurnSchedule",
    "Diurnal",
    "FaultSchedule",
    "HomogeneousPoisson",
    "MMPP",
    "OnOffInterference",
    "OUDrift",
    "PiecewiseRate",
    "RandomChurn",
    "RandomFaults",
    "Reshuffle",
    "Scenario",
    "ServingWorkload",
    "StaticCapacity",
    "StepSchedule",
    "TraceArrivals",
    "make",
    "names",
    "register",
    "run_scenario",
    "run_workload",
    "synthesize_tpch_trace",
]
