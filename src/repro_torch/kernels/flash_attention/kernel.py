"""Wrapper of the hand-written flash-attention forward kernel
(``csrc/flash_attention.cu``), which replaces ``flash_attention_fwd`` of
``src/repro/kernels/flash_attention/kernel.py``.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take. Given CPU tensors it runs the kernel's
plain version (``ref.attention_ref``); given CUDA tensors it launches the
kernel on the current stream or raises. ``launches["flash_attention_fwd"]``
rises by one where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import build, ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

launches = {"flash_attention_fwd": 0}


def _check(q, k, v, q_offset, window) -> tuple[int, int]:
    """(group, D) after checking the inputs; raises on what the kernel
    does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name}: expected a [BH, S, D] tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not in {DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device, got "
                         f"{sorted(map(str, devs))}")
    BH, Sq, D = q.shape
    if k.shape != v.shape or k.shape[2] != D:
        raise ValueError(f"k {list(k.shape)} and v {list(v.shape)} must both be "
                         f"[BH / group, Sk, {D}]")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if k.shape[0] < 1 or BH % k.shape[0] or k.shape[1] < 1 or Sq < 1:
        raise ValueError(f"q {list(q.shape)}, k {list(k.shape)}: need Sq, Sk >= 1 "
                         f"and kv rows dividing q rows")
    if not isinstance(q_offset, int) or not isinstance(window, int) or window < 0:
        raise ValueError("q_offset must be an int and window an int >= 0")
    return BH // k.shape[0], D


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q [BH, Sq, D]; k, v [BH / group, Sk, D], f32 or bf16, D in {32, 64,
    128} -> [BH, Sq, D] in q's dtype."""
    group, D = _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    BH, Sq, _ = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, group, Sq,
            k.shape[1], D, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            int(bool(causal)), window, q_offset,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.LIBRARY.raise_on(err, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return o


def reset_launches() -> None:
    launches["flash_attention_fwd"] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
