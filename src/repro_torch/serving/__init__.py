"""Serving router, its closed-loop simulation (the host loop, and the
one-program loop of ``serving.scanloop`` with every turn on the device),
and the continuous-batching decode engine (``serving.engine``)."""
from repro_torch.serving.router import (  # noqa: F401
    SERVE_COMP_CAP,
    Completion,
    RosellaRouter,
    SequentialPool,
    SimulatedPool,
    run_simulation,
)
from repro_torch.serving.scanloop import (  # noqa: F401
    run_simulation_scan,
    run_workload_scan,
)
