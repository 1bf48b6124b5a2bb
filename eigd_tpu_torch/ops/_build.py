"""Build and load the hand-written CUDA kernels at first use.

``csrc/*.cu`` is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library goes to ``build/eigd_tpu_torch/`` at the root of the
checkout, keyed by a hash of the sources and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The compiler's
``-Xptxas -v`` report (registers, spills, shared memory of each kernel) is
kept beside the library as ``<name>.log``.

Nothing here runs at import: the CPU test suite imports every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "stencil.cu",)
BUILD_DIR = _PKG.parent / "build" / "eigd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libeigd_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile the sources unless an up-to-date library exists.

    Returns (path, log) where log is nvcc's output of the build that made
    the library. Raises with that output if nvcc fails.
    """
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists() and log_path.exists():
        return so, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, log


def load():
    """The loaded kernel library (built at first call), with the ctypes
    signatures of its C entry points set."""
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        args = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                + [ctypes.c_void_p])
        for name in ("eigd_stencil_f32", "eigd_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
