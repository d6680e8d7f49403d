"""Build ``csrc/flash_attention.cu`` with nvcc and load it with ctypes
(through the shared builder ``kernels/_nvcc.py``)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse (or null), B, Hq, Hkv, Sq, Sk, D, bf16, strides (12 x
    # int64), scale, causal, window, q_offset, stream
    "flash_attention_fwd": (_P,) * 5 + (_I,) * 7 + (_P, ctypes.c_float, _I, _I, _I, _P),
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, bf16,
    # strides (24 x int64), scale, causal, window, q_offset, stream
    "flash_attention_bwd": (_P,) * 10 + (_I,) * 7 + (_P, ctypes.c_float, _I, _I, _I, _P),
}

LIBRARY = _nvcc.CudaLibrary(SRC, _SIGNATURES, "flash_error_string")
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load
