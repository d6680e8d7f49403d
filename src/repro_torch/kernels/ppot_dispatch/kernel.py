"""Wrappers of the hand-written PPoT dispatch kernels (``csrc/ppot_dispatch.cu``).

Each wrapper checks device, dtype, shape and contiguity. Given CPU tensors
it runs the kernel's plain version from ``ref.py``; given CUDA tensors it
launches the kernel on the current stream or raises. There is no fallback
from a failed build or launch to the plain version.

Each wrapper counts its launches in ``launches[<name>]``, a plain int
raised by one where the kernel is launched and nowhere else;
``reset_launches``/``launch_counts`` clear and read them. A launch made
while the stream is captured into a CUDA graph is not counted: it runs
on each replay of the graph, without Python, and the graph's owner counts
those (``serving.scanloop``: kernel nodes times replays).

  ppot_dispatch_fused_alias_keyed  K1 as the engine runs it: the probe
                              uniforms drawn in the kernel from the route
                              key (``prng.uniform_quad``), alias probe ->
                              SQ(2) -> fold of the active slots; counted as
                              ``ppot_dispatch_fused_alias``
  ppot_dispatch_fused_alias   the same kernel on given uniforms (the Pallas
                              kernel's contract); counted as
                              ``ppot_dispatch_fused_alias_unkeyed``
  ppot_dispatch_fused         inverse-CDF probe -> SQ(2) -> fold   (K2)
  ppot_dispatch               inverse-CDF probe -> SQ(2), no fold  (K3)
  alias_table                 the alias table from scaled weights: stack
                              order, pairing walk and mask pass

K1 is one launch a call, a thread-block cluster of up to 8 blocks that
stages the table and q by TMA bulk copies and writes the whole of
``q_after`` (q plus the blocks' histograms, summed through distributed
shared memory), so no copy of q is made around it. K2 and K3 search the
cdf by bisection: it must be non-decreasing (see ``ppot_dispatch_fused``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ppot_dispatch import build, ref

launches = {"ppot_dispatch_fused_alias": 0, "ppot_dispatch_fused_alias_unkeyed": 0,
            "ppot_dispatch_fused": 0, "ppot_dispatch": 0, "alias_table": 0}

#: the largest n one alias_table launch takes: its block keeps 12n bytes of
#: shared memory (kTableMaxN in the source)
ALIAS_TABLE_MAX_N = 16384
#: the largest n one K1 launch takes: each block keeps prob, alias, q and
#: its histogram in shared memory, 16n bytes and 64 of alignment
#: (kAliasMaxN in the source)
K1_MAX_N = 14524


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True if the inputs are CUDA tensors, False if CPU ones; raises on a
    mix or any other device."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, size: int) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != size:
        raise ValueError(f"{name}: expected {dtype}[{size}], got "
                         f"{t.dtype}{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor):
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_batch(n: int, **us: torch.Tensor) -> int:
    """The batch size B shared by the f32[B] uniforms; n must be >= 1."""
    if n < 1:
        raise ValueError("need at least one worker")
    first = next(iter(us.values()))
    B = first.shape[0] if first.dim() == 1 else -1
    for name, u in us.items():
        _check(u, name, torch.float32, B)
    return B


def _check_k1(prob, alias, q) -> int:
    n = prob.shape[0]
    _check(prob, "prob", torch.float32, n)
    _check(alias, "alias", torch.int32, n)
    _check(q, "q", torch.int32, n)
    if n < 1:
        raise ValueError("need at least one worker")
    return n


def _k1_fits(n: int) -> None:
    if n > K1_MAX_N:
        raise ValueError(f"ppot_dispatch_fused_alias: n={n} exceeds the {K1_MAX_N} workers "
                         f"one block's shared memory holds")


def ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2):
    """prob f32[n], alias i32[n], q i32[n], u1,v1,u2,v2 f32[B] ->
    (workers i32[B], q_after i32[n])."""
    n = _check_k1(prob, alias, q)
    B = _check_batch(n, u1=u1, v1=v1, u2=u2, v2=v2)
    if not _on_cuda(prob, alias, q, u1, v1, u2, v2):
        return ref.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2)
    _k1_fits(n)
    workers = torch.empty(B, dtype=torch.int32, device=q.device)
    q_after = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load().ppot_fused_alias(
            *map(_ptr, (prob, alias, q, u1, v1, u2, v2)), n, B,
            _ptr(workers), _ptr(q_after), _stream(q))
    build.LIBRARY.raise_on(err, "ppot_dispatch_fused_alias")
    _count("ppot_dispatch_fused_alias_unkeyed")
    return workers, q_after


def ppot_dispatch_fused_alias_keyed(prob, alias, q, key, B: int, active=None):
    """prob f32[n], alias i32[n], q i32[n], the route key, B, active
    bool[B] or None -> (workers i32[B], -1 at an inactive slot; q_after
    i32[n], q plus the active slots' placements).

    The job uniforms are ``prng.uniform_quad(key, B)``'s, drawn in the
    kernel. ``key`` is a host key (two ints, passed by value) or a device
    key, an int64[2] tensor on the other inputs' device that the kernel
    reads (so a captured graph draws each replay's key); it is never read
    on the host."""
    n = _check_k1(prob, alias, q)
    B = int(B)
    if B < 0:
        raise ValueError(f"negative batch size {B}")
    ts = [prob, alias, q]
    if active is not None:
        _check(active, "active", torch.bool, B)
        ts.append(active)
    on_device = isinstance(key, torch.Tensor)
    if on_device:
        if key.dtype != torch.int64 or key.shape != (2,) or not key.is_contiguous():
            raise ValueError(f"key: expected a contiguous torch.int64[2], got "
                             f"{key.dtype}{list(key.shape)}")
        ts.append(key)
        k0 = k1 = 0
    else:
        k0, k1 = (int(w) for w in key)
        if not (0 <= k0 < 2**32 and 0 <= k1 < 2**32):
            raise ValueError(f"key: words must be u32, got ({k0}, {k1})")
    if not _on_cuda(*ts):
        return ref.ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, B, active)
    _k1_fits(n)
    workers = torch.empty(B, dtype=torch.int32, device=q.device)
    q_after = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load().ppot_fused_alias_keyed(
            _ptr(prob), _ptr(alias), _ptr(q), _ptr(key) if on_device else None, k0, k1,
            None if active is None else _ptr(active), n, B, _ptr(workers), _ptr(q_after),
            _stream(q))
    build.LIBRARY.raise_on(err, "ppot_dispatch_fused_alias")
    _count("ppot_dispatch_fused_alias")
    return workers, q_after


def ppot_dispatch_fused(cdf, q, u1, u2):
    """cdf f32[n], q i32[n], u1,u2 f32[B] -> (workers i32[B], q_after i32[n]).

    The kernel finds each probe by bisection, which equals the plain
    version's dense count #{i : cdf[i] <= u} only where ``cdf`` is
    non-decreasing and has no NaN. ``ref.make_cdf`` and
    ``core.dispatch.masked_cdf`` give that order by construction; the
    wrapper does not check it on the card (a launch and a sync)."""
    n = cdf.shape[0]
    _check(cdf, "cdf", torch.float32, n)
    _check(q, "q", torch.int32, n)
    B = _check_batch(n, u1=u1, u2=u2)
    if not _on_cuda(cdf, q, u1, u2):
        return ref.ppot_dispatch_fused_ref(cdf, q, u1, u2)
    workers = torch.empty(B, dtype=torch.int32, device=q.device)
    q_after = q.clone()
    if B == 0:
        return workers, q_after
    with torch.cuda.device(q.device):
        err = build.load().ppot_fused_cdf(
            *map(_ptr, (cdf, q, u1, u2)), n, B, _ptr(workers), _ptr(q_after),
            _stream(q))
    build.LIBRARY.raise_on(err, "ppot_dispatch_fused")
    _count("ppot_dispatch_fused")
    return workers, q_after


def ppot_dispatch(cdf, q, u1, u2):
    """cdf f32[n], q i32[n], u1,u2 f32[B] -> workers i32[B] (no fold-back).
    ``cdf`` must be non-decreasing, as for ``ppot_dispatch_fused``."""
    n = cdf.shape[0]
    _check(cdf, "cdf", torch.float32, n)
    _check(q, "q", torch.int32, n)
    B = _check_batch(n, u1=u1, u2=u2)
    if not _on_cuda(cdf, q, u1, u2):
        return ref.ppot_dispatch_ref(cdf, q, u1, u2)
    workers = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return workers
    with torch.cuda.device(q.device):
        err = build.load().ppot_select_cdf(
            *map(_ptr, (cdf, q, u1, u2)), n, B, _ptr(workers), _stream(q))
    build.LIBRARY.raise_on(err, "ppot_dispatch")
    _count("ppot_dispatch")
    return workers


def alias_table(p, active=None):
    """p f32[n] scaled weights (mean 1), active bool[n] or None ->
    (prob f32[n], alias i32[n]): the stack order, the pairing walk and,
    with a mask, the mask pass, in one launch."""
    n = p.shape[0]
    _check(p, "p", torch.float32, n)
    if n < 1:
        raise ValueError("need at least one worker")
    if active is not None:
        _check(active, "active", torch.bool, n)
    if not _on_cuda(*((p,) if active is None else (p, active))):
        return ref.alias_table_ref(p, active)
    if n > ALIAS_TABLE_MAX_N:
        raise ValueError(f"alias_table: n={n} exceeds the {ALIAS_TABLE_MAX_N} "
                         f"bins one block's shared memory holds")
    prob = torch.empty(n, dtype=torch.float32, device=p.device)
    alias = torch.empty(n, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = build.load().alias_table(
            _ptr(p), None if active is None else _ptr(active), n, _ptr(prob),
            _ptr(alias), _stream(p))
    build.LIBRARY.raise_on(err, "alias_table")
    _count("alias_table")
    return prob, alias


def _count(name: str) -> None:
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
