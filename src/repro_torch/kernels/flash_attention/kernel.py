"""Wrappers of the hand-written flash-attention kernels
(``csrc/flash_attention.cu``): the forward (K4), which replaces
``flash_attention_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``
and, asked through ``flash_attention_heads(return_lse=True)``, also gives
each row's log-sum-exp; and
the backward (K4b, ``flash_attention_bwd_heads``), the counterpart of the
JAX package's ``_flash_bwd`` (``src/repro/models/layers.py:232-298``).

Two layouts reach the one kernel:

  flash_attention_fwd    the reference's: q [BH, Sq, D], k/v [BH / g, Sk, D],
                         contiguous (q row bh reads kv row bh // g)
  flash_attention_heads  the model's: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
                         read in place through their strides (D contiguous)
                         -> o [B, Sq, Hq, D]; q head h reads kv head
                         h // (Hq / Hkv)

The wrapper checks device, dtype, shape, contiguity or strides, and raises
on anything the kernel does not take. Given CPU tensors it runs the
kernel's plain version (``ref.attention_ref``, ``ref.attention_heads_ref``);
given CUDA tensors it launches the kernel on the current stream or raises.
``launches["flash_attention_fwd"]`` rises by one where the forward is
launched, from either entry, and nowhere else; ``launches
["flash_attention_bwd"]`` by one a backward call (its three grids: delta,
dk/dv, dq).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# the kernel's tiles (csrc/flash_attention.cu, Tile<D>): 64 query rows,
# 128 keys (64 at D = 128); ref.tile_plan names the tiles it visits
BLOCK_Q = 64
BLOCK_K = {32: 128, 64: 128, 128: 64}

launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def _check(q, k, v, q_offset, window, *, heads: bool) -> None:
    """Raise on what the kernel does not take (layouts: see the module
    docstring)."""
    rank, layout = (4, "[B, S, H, D]") if heads else (3, "[BH, S, D]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != rank:
            raise ValueError(f"{name}: expected a {layout} tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not in {DTYPES}")
        if heads:
            # the kernel reads rows through strides (TMA: 16-byte multiples)
            if t.stride(-1) != 1 or any(s % 8 for n, s in zip(t.shape[:-1], t.stride()[:-1])
                                        if n > 1):
                raise ValueError(f"{name}: strides {t.stride()} must end in 1 and be "
                                 f"multiples of 8 elements")
            if t.device.type == "cuda" and t.data_ptr() % 16:
                raise ValueError(f"{name}: data must be 16-byte aligned")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device, got "
                         f"{sorted(map(str, devs))}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if heads:
        B, Sq, H = q.shape[:3]
        ok = (k.shape == v.shape and k.shape[0] == B and k.shape[3] == D
              and k.shape[2] >= 1 and H % k.shape[2] == 0)
    else:
        H, Sq = q.shape[:2]
        ok = (k.shape == v.shape and k.shape[2] == D and k.shape[0] >= 1
              and H % k.shape[0] == 0)
    if not ok or Sq < 1 or k.shape[1] < 1:
        want = ("k = v = [B, Sk, Hkv, D] with Hkv dividing Hq" if heads
                else "k = v = [BH / group, Sk, D]")
        raise ValueError(f"q {list(q.shape)}, k {list(k.shape)}, v {list(v.shape)}: "
                         f"expected {want}, Sq, Sk >= 1")
    if not isinstance(q_offset, int) or not isinstance(window, int) or window < 0:
        raise ValueError("q_offset must be an int and window an int >= 0")


def _launch(q, k, v, o, lse, *, B, Hq, Hkv, Sq, Sk, strides, causal, window, q_offset):
    D = q.shape[-1]
    st = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        err = build.load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
            int(q.dtype == torch.bfloat16), st, 1.0 / math.sqrt(D), int(bool(causal)),
            window, q_offset, torch.cuda.current_stream(q.device).cuda_stream)
    build.LIBRARY.raise_on(err, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1


def _bsh(t) -> tuple[int, int, int]:
    """(batch, seq, head) element strides of a [B, S, H, D] view; a dim of
    size 1 gets a stride TMA takes (any multiple of 16 bytes)."""
    return tuple(s if n > 1 else 8 for n, s in zip(t.shape[:3], t.stride()[:3]))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q [BH, Sq, D]; k, v [BH / group, Sk, D], f32 or bf16, D in {32, 64,
    128} -> [BH, Sq, D] in q's dtype."""
    _check(q, k, v, q_offset, window, heads=False)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    BH, Sq, D = q.shape
    BHk, Sk = k.shape[:2]
    o = torch.empty_like(q)
    # [BH, S, D] as a [1, S, BH, D] view: heads Sq*D apart, rows D apart
    qs = (8, D, Sq * D)
    ks = (8, D, Sk * D)
    _launch(q, k, v, o, None, B=1, Hq=BH, Hkv=BHk, Sq=Sq, Sk=Sk,
            strides=qs + ks + ks + qs, causal=causal, window=window, q_offset=q_offset)
    return o


def flash_attention_heads(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, return_lse: bool = False):
    """q [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] with Hkv dividing Hq, read in
    place (D contiguous, strides multiples of 8 elements), f32 or bf16, D in
    {32, 64, 128} -> o [B, Sq, Hq, D] (contiguous) in q's dtype, and with
    ``return_lse`` (o, lse f32 [B, Hq, Sq])."""
    _check(q, k, v, q_offset, window, heads=True)
    if q.device.type == "cpu":
        return ref.attention_heads_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, return_lse=return_lse)
    B, Sq, Hq, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) if return_lse
           else None)
    _launch(q, k, v, o, lse, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
            strides=_bsh(q) + _bsh(k) + _bsh(v) + _bsh(o), causal=causal, window=window,
            q_offset=q_offset)
    return o if lse is None else (o, lse)


def flash_attention_bwd_heads(q, k, v, o, dout, lse, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """K4b: the gradients of ``flash_attention_heads`` at output cotangent
    ``dout``. q, o, dout [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D], read in place
    as the forward reads them, one dtype; lse f32 [B, Hq, Sq], the forward's.
    Returns (dq [B, Sq, Hq, D], dk, dv [B, Sk, Hkv, D]), contiguous, in the
    inputs' dtype; dk and dv summed over each kv head's q heads."""
    _check(q, k, v, q_offset, window, heads=True)
    _check(o, dout, dout, q_offset, window, heads=True)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {list(o.shape)} and dout {list(dout.shape)} must be q's "
                         f"{list(q.shape)}, in q's dtype")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous f32 [B, Hq, Sq] = {[B, Hq, Sq]} tensor "
                         f"on q's device")
    if q.device.type == "cpu":
        return ref.attention_bwd_heads_ref(q, k, v, o, dout, lse, causal=causal,
                                           window=window, q_offset=q_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    strides = sum((_bsh(t) for t in (q, k, v, o, dout, dq, dk, dv)), ())
    st = (ctypes.c_longlong * 24)(*strides)
    with torch.cuda.device(q.device):
        err = build.load().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16), st, 1.0 / math.sqrt(D),
            int(bool(causal)), window, q_offset,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.LIBRARY.raise_on(err, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
