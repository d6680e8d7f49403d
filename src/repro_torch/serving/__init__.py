"""Serving router and its closed-loop simulation."""
from repro_torch.serving.router import (  # noqa: F401
    SERVE_COMP_CAP,
    RosellaRouter,
    SequentialPool,
    SimulatedPool,
    run_simulation,
)
