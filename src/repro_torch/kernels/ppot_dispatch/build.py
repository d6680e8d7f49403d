"""Build ``csrc/ppot_dispatch.cu`` with nvcc and load it with ctypes
(through the shared builder ``kernels/_nvcc.py``)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "ppot_dispatch.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    # prob, alias, q, u1, v1, u2, v2, n, B, workers, q_after, stream
    "ppot_fused_alias": (_P,) * 7 + (_I, _I, _P, _P, _P),
    # prob, alias, q, key (device int64[2] or null), k0, k1, active (or
    # null), n, B, workers, q_after, stream
    "ppot_fused_alias_keyed": (_P,) * 4 + (_U, _U, _P, _I, _I, _P, _P, _P),
    # cdf, q, u1, u2, n, B, workers, q_after, stream
    "ppot_fused_cdf": (_P,) * 4 + (_I, _I, _P, _P, _P),
    # cdf, q, u1, u2, n, B, workers, stream
    "ppot_select_cdf": (_P,) * 4 + (_I, _I, _P, _P),
    # p, active (or null), n, prob, alias, stream
    "alias_table": (_P, _P, _I, _P, _P, _P),
}

LIBRARY = _nvcc.CudaLibrary(SRC, _SIGNATURES, "ppot_error_string")
nvcc = _nvcc.nvcc
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load
