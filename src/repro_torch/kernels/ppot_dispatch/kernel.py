"""Wrappers of the hand-written PPoT dispatch kernels (``csrc/ppot_dispatch.cu``).

Each wrapper checks device, dtype, shape and contiguity. Given CPU tensors
it runs the kernel's plain version from ``ref.py``; given CUDA tensors it
launches the kernel on the current stream or raises. There is no fallback
from a failed build or launch to the plain version.

Each wrapper counts its launches in ``launches[<wrapper name>]``, a plain
int raised by one where the kernel is launched and nowhere else;
``reset_launches``/``launch_counts`` clear and read them.

  ppot_dispatch_fused_alias   alias probe -> SQ(2) -> fold-back    (K1)
  ppot_dispatch_fused         inverse-CDF probe -> SQ(2) -> fold   (K2)
  ppot_dispatch               inverse-CDF probe -> SQ(2), no fold  (K3)
  alias_pairing               the alias table's pairing walk
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ppot_dispatch import build, ref

launches = {"ppot_dispatch_fused_alias": 0, "ppot_dispatch_fused": 0,
            "ppot_dispatch": 0, "alias_pairing": 0}


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


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = build.load().ppot_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


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


def ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2):
    """prob f32[n], alias i32[n], q i32[n], u1,v1,u2,v2 f32[B] ->
    (workers i32[B], q_after i32[n])."""
    n = prob.shape[0]
    _check(prob, "prob", torch.float32, n)
    _check(alias, "alias", torch.int32, n)
    _check(q, "q", torch.int32, n)
    B = _check_batch(n, u1=u1, v1=v1, u2=u2, v2=v2)
    if not _on_cuda(prob, alias, q, u1, v1, u2, v2):
        return ref.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2)
    workers = torch.empty(B, dtype=torch.int32, device=q.device)
    q_after = q.clone()  # seeded here: the blocks only add their histograms
    if B == 0:
        return workers, q_after
    with torch.cuda.device(q.device):
        err = build.load().ppot_fused_alias(
            *map(_ptr, (prob, alias, q, u1, v1, u2, v2)), n, B,
            _ptr(workers), _ptr(q_after), _stream(q))
    _raise_on(err, "ppot_dispatch_fused_alias")
    launches["ppot_dispatch_fused_alias"] += 1
    return workers, q_after


def ppot_dispatch_fused(cdf, q, u1, u2):
    """cdf f32[n], q i32[n], u1,u2 f32[B] -> (workers i32[B], q_after i32[n])."""
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
    _raise_on(err, "ppot_dispatch_fused")
    launches["ppot_dispatch_fused"] += 1
    return workers, q_after


def ppot_dispatch(cdf, q, u1, u2):
    """cdf f32[n], q i32[n], u1,u2 f32[B] -> workers i32[B] (no fold-back)."""
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
    _raise_on(err, "ppot_dispatch")
    launches["ppot_dispatch"] += 1
    return workers


def alias_pairing(p, stack, ns0):
    """p f32[n] scaled weights (mean 1), stack i32[n] (smalls then larges,
    each in index order), ns0 i32[1] number of smalls ->
    (prob f32[n], alias i32[n])."""
    n = p.shape[0]
    _check(p, "p", torch.float32, n)
    _check(stack, "stack", torch.int32, n)
    _check(ns0, "ns0", torch.int32, 1)
    if not _on_cuda(p, stack, ns0):
        return ref.alias_pairing_ref(p, stack, ns0)
    prob = torch.empty(n, dtype=torch.float32, device=p.device)
    alias = torch.empty(n, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = build.load().alias_pairing(
            _ptr(p), _ptr(stack), _ptr(ns0), n, _ptr(prob), _ptr(alias),
            _stream(p))
    _raise_on(err, "alias_pairing")
    launches["alias_pairing"] += 1
    return prob, alias


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
