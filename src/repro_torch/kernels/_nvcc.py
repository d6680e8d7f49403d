"""Build a CUDA source with nvcc into a shared library and load it with ctypes.

Each source has a plain C interface (no PyTorch headers), so it builds in
seconds. It is built at first use into ``build/`` at the repository root,
one library per source, named by a hash of the source and flags so that an
edited source never loads a stale library, and written under a temporary
name and renamed so that concurrent first uses never load a half-written
file. ``build_all`` starts one nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class CudaLibrary:
    """One ``.cu`` source, its entry points' argtypes (each returns a
    ``cudaError_t`` as int), the name of its error-string function and any
    nvcc flags of its own after the shared ones."""

    def __init__(self, src: Path, signatures: dict, error_fn: str,
                 extra_flags: tuple = ()):
        self.src = Path(src)
        self.signatures = signatures
        self.error_fn = error_fn
        self.flags = FLAGS + tuple(extra_flags)
        self.build_log = ""  # nvcc's output (ptxas register/shared-memory report)
        self._lib: ctypes.CDLL | None = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.src.read_bytes() + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.src.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless this source's build already exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([nvcc(), *self.flags, "-o", tmp, str(self.src)],
                                 capture_output=True, text=True)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.src.name}:\n{self.build_log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def load(self) -> ctypes.CDLL:
        """The built library with every entry point's argtypes declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, args in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            err = getattr(lib, self.error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def raise_on(self, err: int, name: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = getattr(self.load(), self.error_fn)(err).decode()
            raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def build_all(*libs: CudaLibrary) -> None:
    """Build every library, one nvcc process per source, all at once."""
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs]:
            fut.result()
