"""Build ``csrc/ppot_dispatch.cu`` with nvcc and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so it builds in
seconds. It is built at first use into ``build/`` at the repository root,
named by a hash of the source and flags so that an edited source never
loads a stale library, and written under a temporary name and renamed so
that concurrent first uses never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "ppot_dispatch.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # prob, alias, q, u1, v1, u2, v2, n, B, workers, q_after, stream
    "ppot_fused_alias": (_P,) * 7 + (_I, _I, _P, _P, _P),
    # cdf, q, u1, u2, n, B, workers, q_after, stream
    "ppot_fused_cdf": (_P,) * 4 + (_I, _I, _P, _P, _P),
    # cdf, q, u1, u2, n, B, workers, stream
    "ppot_select_cdf": (_P,) * 4 + (_I, _I, _P, _P),
    # p, stack, ns0, n, prob, alias, stream
    "alias_pairing": (_P, _P, _P, _I, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libppot_dispatch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([nvcc(), *FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SRC.name}:\n{build_log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.ppot_error_string.argtypes = [ctypes.c_int]
        lib.ppot_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
