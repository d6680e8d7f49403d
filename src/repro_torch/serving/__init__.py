"""Serving router, its closed-loop simulation, and the continuous-batching
decode engine (``serving.engine``)."""
from repro_torch.serving.router import (  # noqa: F401
    SERVE_COMP_CAP,
    Completion,
    RosellaRouter,
    SequentialPool,
    SimulatedPool,
    run_simulation,
)
