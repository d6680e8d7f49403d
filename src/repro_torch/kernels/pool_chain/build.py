"""Build ``csrc/pool_chain.cu`` with nvcc and load it with ctypes (through
the shared builder ``kernels/_nvcc.py``)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "pool_chain.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # free_at, speeds, workers, arrivals, costs, active, n, M, start, done,
    # free_out, stream
    "pool_chain": (_P,) * 6 + (_I, _I) + (_P,) * 4,
    # free_at, speeds, fake_js, burst, workers, times, costs, fake_cost,
    # burst_cost, n, mf, bc, k, start, done, sub_w, act, free_out, resp,
    # chain_max, stream
    "pool_turn": (_P,) * 7 + (_D, _D) + (_I,) * 4 + (_P,) * 8,
    # as pool_turn, with tail_w, tail_cost, tail_gate after costs and R
    # after k
    "pool_turn_tail": (_P,) * 10 + (_D, _D) + (_I,) * 5 + (_P,) * 8,
}

LIBRARY = _nvcc.CudaLibrary(SRC, _SIGNATURES, "pool_chain_error_string")
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load
