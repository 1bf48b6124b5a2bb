"""Build and load the hand-written CUDA kernels at first use.

``csrc/*.cu`` is compiled with nvcc into one shared library with a plain C
interface and loaded with ctypes (no PyTorch headers, so the build takes
seconds): one nvcc per source, all started together, then one link, so
the build takes about as long as its slowest source. The library goes to
``build/eigd_tpu_torch/`` at the root of the checkout, keyed by a hash of
all the sources and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The compiler's
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "stencil.cu", _PKG / "csrc" / "probes.cu")
BUILD_DIR = _PKG.parent / "build" / "eigd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _run(cmd):
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=False)
    return proc.returncode, " ".join(cmd) + "\n" + proc.stdout


def compile_library(out, jobs=None):
    """Compile every source to an object, ``jobs`` nvcc at a time (default:
    all at once), and link them into the shared library ``out``.

    Returns (ok, log): nvcc's return codes were all 0, and its output."""
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    with ThreadPoolExecutor(jobs or len(cmds)) as pool:
        runs = list(pool.map(_run, cmds))
    if all(rc == 0 for rc, _ in runs):
        runs.append(_run([nvcc, "-shared", "-o", str(out), *map(str, objs)]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    return all(rc == 0 for rc, _ in runs), "".join(log for _, log in runs)


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
    ok, log = compile_library(tmp)
    if not ok:
        raise RuntimeError(f"nvcc failed:\n{log}")
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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "eigd_stencil_f32": [ptr] * 3 + [i32] * 14 + [ptr],
            "eigd_stencil_f64": [ptr] * 3 + [i32] * 14 + [ptr],
            "eigd_probe_rows": [ptr] * 3 + [i32, ptr, ptr] + [i32] * 3
                               + [i64] * 3 + [i32] * 3 + [ptr],
            "eigd_probe_taps": [i32] + [ptr] * 5 + [i32] * 4 + [i64] * 2
                               + [ptr],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
