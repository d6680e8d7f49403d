"""Build ``csrc/ssd_scan.cu`` with nvcc and load it with ctypes (through
``kernels/_nvcc.py``, which every kernel source shares)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, dt, A, Bm, Cm, y, h, states, cum, cb (scratch), BH, heads, G, nA,
    # S, P, N, Q, bf16, stream
    "ssd_scan": (_P,) * 10 + (_I,) * 9 + (_P,),
}

LIBRARY = _nvcc.CudaLibrary(SRC, _SIGNATURES, "ssd_error_string")
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load
