"""How long the kernel library takes to build, serially and in parallel.

Compiles ``ops/_build.SOURCES`` into a scratch library under
``build/eigd_tpu_torch/`` with one nvcc at a time and with one nvcc per
source started together (``_build.build``'s way), in the order serial,
parallel, parallel, serial, and prints each wall time. The library that
``_build.build`` loads is not touched.

Run on a machine with nvcc, from the root of the repository:

    python -m eigd_tpu_torch.diag.build_time
"""

from __future__ import annotations

import time

from ..ops import _build


def main():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "build_time.tmp.so"
    names = ", ".join(src.name for src in _build.SOURCES)
    for jobs in (1, None, None, 1):
        t0 = time.perf_counter()
        ok, log = _build.compile_library(out, jobs)
        wall = time.perf_counter() - t0
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{log}")
        mode = "serial" if jobs == 1 else "parallel"
        print(f"[build_time] {names}: {mode} {wall:.2f} s", flush=True)
    out.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
