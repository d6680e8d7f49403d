"""Serving router, its closed-loop simulation (the host loop, and the
one-program loop of ``serving.scanloop`` with every turn on the device),
the frontend fleet over one replica pool (``FleetRouter``, its host loop
and its one-program loop), and the continuous-batching decode engine
(``serving.engine``)."""
from repro_torch.serving.router import (  # noqa: F401
    SERVE_COMP_CAP,
    Completion,
    FleetRouter,
    RosellaRouter,
    SequentialPool,
    SimulatedPool,
    run_fleet_simulation,
    run_simulation,
)
from repro_torch.serving.scanloop import (  # noqa: F401
    run_fleet_simulation_scan,
    run_fleet_workload_scan,
    run_simulation_scan,
    run_workload_scan,
)
