"""Wrapper of the hand-written pool-chain kernel (``csrc/pool_chain.cu``).

It checks device, dtype, shape and contiguity. Given CPU tensors it runs
the plain version from ``ref.py``; given CUDA tensors it launches the
kernel on the current stream or raises. There is no fallback from a
failed build or launch to the plain version.

``launches["pool_chain"]`` counts launches: a plain int raised by one
where the kernel is launched and nowhere else. A launch made while the
stream is captured into a CUDA graph is not counted: it runs on each
replay of the graph, without Python, and the graph's owner counts those
(``serving.scanloop``: kernel nodes times replays).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pool_chain import build, ref

launches = {"pool_chain": 0}

#: the largest n and M one launch takes: its block keeps 8n + 21M bytes of
#: shared memory (kMaxN, kMaxM in the source)
MAX_N, MAX_M = 16384, 4096


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, size: int) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != size:
        raise ValueError(f"{name}: expected {dtype}[{size}], got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def pool_chain(free_at, speeds, workers, arrivals, costs, active):
    """free_at f64[n], speeds f64[n], workers i32[M], arrivals f64[M],
    costs f64[M], active bool[M] -> (start f64[M], done f64[M], free_at'
    f64[n]). Workers must lie in [0, n)."""
    n, M = free_at.shape[0], workers.shape[0]
    _check(free_at, "free_at", torch.float64, n)
    _check(speeds, "speeds", torch.float64, n)
    _check(workers, "workers", torch.int32, M)
    _check(arrivals, "arrivals", torch.float64, M)
    _check(costs, "costs", torch.float64, M)
    _check(active, "active", torch.bool, M)
    ts = (free_at, speeds, workers, arrivals, costs, active)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return ref.pool_chain_ref(*ts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (1 <= n <= MAX_N and M <= MAX_M):
        raise ValueError(f"pool_chain: n={n}, M={M} outside n <= {MAX_N}, M <= {MAX_M}")
    start = torch.empty(M, dtype=torch.float64, device=dev)
    done = torch.empty(M, dtype=torch.float64, device=dev)
    free_out = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = build.load().pool_chain(
            *(t.data_ptr() for t in ts), n, M, start.data_ptr(), done.data_ptr(),
            free_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.raise_on(err, "pool_chain")
    if not torch.cuda.is_current_stream_capturing():
        launches["pool_chain"] += 1
    return start, done, free_out


def reset_launches() -> None:
    launches["pool_chain"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
