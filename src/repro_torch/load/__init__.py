"""repro_torch.load — the trace-scale streaming load harness.

``traces``: cluster-trace-shaped arrival/cost generators (Azure-like
serverless shape, Google-like batch shape) that stream in blocks.
``stream``: ``ScenarioStream`` (lazy chunked ``compile_serving``) +
``run_stream_scan`` (chunked one-program loop with the carry crossing
chunk boundaries on the device) — million-request horizons in bounded
memory. The port's copy of the JAX package's ``repro.load``.
"""
from repro_torch.load.stream import (  # noqa: F401
    ScenarioStream,
    run_stream_scan,
)
from repro_torch.load.traces import (  # noqa: F401
    AzureLikeTrace,
    GoogleLikeTrace,
    stream_arrivals,
)
