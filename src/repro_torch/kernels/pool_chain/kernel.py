"""Wrappers of the hand-written pool-chain kernel (``csrc/pool_chain.cu``).

``pool_chain`` takes the steps as arrays; ``pool_turn`` takes a serving
turn's three groups, and the faulty turn's tail of retry and speculative
copies, and assembles the steps in the same launch. Each
checks device, dtype, shape and contiguity. Given CPU tensors it runs its
plain version from ``ref.py``; given CUDA tensors it launches the kernel on
the current stream or raises. There is no fallback from a failed build or
launch to the plain version.

``launches["pool_chain"]`` counts launches of either entry point: a plain
int raised by one where the kernel is launched and nowhere else. A launch
made while the stream is captured into a CUDA graph is not counted: it
runs on each replay of the graph, without Python, and the graph's owner
counts those (``serving.scanloop``: kernel nodes times replays).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pool_chain import build, ref

launches = {"pool_chain": 0}

#: the largest n one launch takes, and the most steps M at that n: its block
#: keeps 4n + 34M bytes of shared memory, at most SMEM_BYTES (kMaxN, kMaxM,
#: kMaxSmem in the source), so fewer replicas leave room for more steps
MAX_N, MAX_M = 16384, 4096
SMEM_BYTES = 4 * MAX_N + 34 * MAX_M


def max_steps(n: int) -> int:
    """The most steps one launch takes beside ``n`` replicas."""
    return (SMEM_BYTES - 4 * n) // 34


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype}{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device(ts) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _fits(n: int, M: int) -> None:
    if not (1 <= n <= MAX_N and M <= max_steps(n)):
        raise ValueError(f"pool_chain: n={n}, M={M} outside n <= {MAX_N}, "
                         f"4n + 34M <= {SMEM_BYTES}")


def _counted() -> None:
    if not torch.cuda.is_current_stream_capturing():
        launches["pool_chain"] += 1


def pool_chain(free_at, speeds, workers, arrivals, costs, active):
    """free_at f64[n], speeds f64[n], workers i32[M], arrivals f64[M],
    costs f64[M], active bool[M] -> (start f64[M], done f64[M], free_at'
    f64[n]). Workers must lie in [0, n)."""
    n, M = free_at.shape[0], workers.shape[0]
    for t, name, dt, size in ((free_at, "free_at", torch.float64, n),
                              (speeds, "speeds", torch.float64, n),
                              (workers, "workers", torch.int32, M),
                              (arrivals, "arrivals", torch.float64, M),
                              (costs, "costs", torch.float64, M),
                              (active, "active", torch.bool, M)):
        _check(t, name, dt, (size,))
    ts = (free_at, speeds, workers, arrivals, costs, active)
    dev = _device(ts)
    if dev.type == "cpu":
        return ref.pool_chain_ref(*ts)
    _fits(n, M)
    start = torch.empty(M, dtype=torch.float64, device=dev)
    done = torch.empty(M, dtype=torch.float64, device=dev)
    free_out = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = build.load().pool_chain(
            *(t.data_ptr() for t in ts), n, M, start.data_ptr(), done.data_ptr(),
            free_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.raise_on(err, "pool_chain")
    _counted()
    return start, done, free_out


def pool_turn(free_at, speeds, fake_js, burst, workers, times, costs, fake_cost: float,
              burst_cost: float, *, tail_w=None, tail_cost=None, tail_gate=None,
              free_out=None, chain_max=None):
    """A serving turn's replica chain from its groups: benchmark replicas
    fake_js i32[mf] (-1 inactive), probe-burst targets burst i32[bc] (-1 a
    pad), the batch's replicas workers i32[k], arrival times f64[k] and
    costs f64[k], k >= 1, on free_at f64[n] and speeds f64[n]; and
    optionally a tail after the batch (the faulty turn's retry and
    speculative copies): replicas tail_w i32[R], costs tail_cost f64[R] and
    gates tail_gate bool[R], arriving at the turn's time, active where the
    gate is set and the replica is not negative. No tail is the plain
    turn.

    Returns (start f64[M], done f64[M], sub_w i32[M], act bool[M], free_at'
    f64[n], resp f64[k]), M = mf + bc + k + R, as ``ref.pool_turn_ref``.
    With ``free_out`` (f64[n], may be ``free_at`` itself) the new clocks
    are written there; ``chain_max`` (an i32 scalar) is raised to the
    longest chain of this turn. Replicas must lie in [0, n) (negative ones
    where inactive)."""
    n, mf, bc, k = free_at.shape[0], fake_js.shape[0], burst.shape[0], workers.shape[0]
    if k < 1:
        raise ValueError("pool_turn: the batch is empty")
    tail = (tail_w, tail_cost, tail_gate)
    if any(t is None for t in tail) and any(t is not None for t in tail):
        raise ValueError("pool_turn: give tail_w, tail_cost and tail_gate together")
    R = 0 if tail_w is None else tail_w.shape[0]
    checks = [(free_at, "free_at", torch.float64, (n,)), (speeds, "speeds", torch.float64, (n,)),
              (fake_js, "fake_js", torch.int32, (mf,)), (burst, "burst", torch.int32, (bc,)),
              (workers, "workers", torch.int32, (k,)), (times, "times", torch.float64, (k,)),
              (costs, "costs", torch.float64, (k,))]
    if tail_w is not None:
        checks += [(tail_w, "tail_w", torch.int32, (R,)),
                   (tail_cost, "tail_cost", torch.float64, (R,)),
                   (tail_gate, "tail_gate", torch.bool, (R,))]
    if free_out is not None:
        checks.append((free_out, "free_out", torch.float64, (n,)))
    if chain_max is not None:
        checks.append((chain_max, "chain_max", torch.int32, ()))
    for t, name, dt, shape in checks:
        _check(t, name, dt, shape)
    dev = _device([c[0] for c in checks])
    if dev.type == "cpu":
        *out, fa, resp = ref.pool_turn_ref(free_at, speeds, fake_js, burst, workers, times,
                                           costs, fake_cost, burst_cost, *tail)
        if chain_max is not None:
            chain_max.clamp_(min=ref.longest_chain(out[2], n))
        if free_out is not None:
            fa = free_out.copy_(fa)
        return (*out, fa, resp)
    M = mf + bc + k + R
    _fits(n, M)
    f64 = dict(dtype=torch.float64, device=dev)
    start, done, resp = torch.empty(M, **f64), torch.empty(M, **f64), torch.empty(k, **f64)
    sub_w = torch.empty(M, dtype=torch.int32, device=dev)
    act = torch.empty(M, dtype=torch.bool, device=dev)
    if free_out is None:
        free_out = torch.empty(n, **f64)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = build.load().pool_turn_tail(
            *(t.data_ptr() for t in (free_at, speeds, fake_js, burst, workers, times, costs)),
            *(ptr(t) for t in tail), float(fake_cost), float(burst_cost), n, mf, bc, k, R,
            *(t.data_ptr() for t in (start, done, sub_w, act, free_out, resp)),
            ptr(chain_max), torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.raise_on(err, "pool_turn")
    _counted()
    return start, done, sub_w, act, free_out, resp


def reset_launches() -> None:
    launches["pool_chain"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
