"""Rank launcher: the port's counterpart of building a ``Mesh``.

JAX's shard_map runs one program over the devices of a mesh from a single
process; torch's process groups need one process per rank. ``run`` spawns
them (the ``spawn`` start method, so a parent that holds threads or a CUDA
context is never forked), starts the process group of each through a
``FileStore`` in a temporary directory (no TCP port, so concurrent
launches on one host cannot collide), pins each rank's device, gives the
group a timeout, and joins with a deadline after which it kills every
rank and raises. A failing rank's traceback is raised in the parent.

The rank function is called as ``fn(axis, *args)`` with the rank's
``collective.Axis``; it must be importable from its module (a spawned
child imports it by name) and return something picklable. Tensors in the
result come back as numpy arrays.

``local_axis`` starts a world-1 group in the calling process instead.
Both run on the card unless given ``device="cpu"``; with no CUDA device
they raise before anything starts.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback


def require(device):
    """Raise where ``device`` names CUDA and no CUDA device is available,
    so that a run never carries on quietly on the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")


def plan(device, nranks):
    """(per-rank devices, backend) for ``nranks`` ranks on ``device``
    ("cpu", "cuda" or "cuda:i").

    CPU ranks use gloo. CUDA ranks each get their own card while there are
    enough, under NCCL; past that they share one card, where NCCL refuses
    two ranks on one device, so they use gloo (``Axis.staged``).
    """
    import torch

    require(device)
    dev = torch.device(device)
    if dev.type == "cpu":
        return ["cpu"] * nranks, "gloo"
    if dev.index is None and torch.cuda.device_count() >= nranks:
        return [f"cuda:{r}" for r in range(nranks)], "nccl"
    card = f"cuda:{dev.index or 0}"
    return [card] * nranks, ("nccl" if nranks == 1 else "gloo")


def _to_host(out):
    import torch

    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


def _init(rank, nranks, store_path, device, backend, timeout):
    import torch
    import torch.distributed as dist

    from ..ops.collective import Axis

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, nranks)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nranks,
                            timeout=datetime.timedelta(seconds=timeout))
    return Axis(None, dev)


def _rank_main(rank, nranks, store_path, device, backend, timeout, fn, args,
               results):
    import torch
    import torch.distributed as dist

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        axis = _init(rank, nranks, store_path, device, backend, timeout)
        out = fn(axis, *args)
        results.put((rank, True, _to_host(out)))
    except Exception:  # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, nranks, args=(), device="cuda", timeout=300.0):
    """``fn(axis, *args)`` on ``nranks`` spawned ranks; the list of their
    results in rank order.

    ``timeout`` (seconds) is both the process group's timeout and the
    deadline of the whole run: past it every rank is killed and
    ``TimeoutError`` raised. A rank that raises, or dies, kills the others
    and raises ``RuntimeError`` with its traceback.
    """
    import multiprocessing as mp

    devices, backend = plan(device, nranks)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="eigd_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nranks, os.path.join(tmp, "store"),
                               devices[r], backend, timeout, fn, args,
                               results))
             for r in range(nranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got = {}
        while len(got) < nranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{fn.__name__} on {nranks} ranks ({backend}) passed "
                    f"its {timeout:g} s deadline; {sorted(got)} finished")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"{fn.__name__}: a rank died (exit codes {dead})")
                continue
            if not ok:
                raise RuntimeError(
                    f"{fn.__name__} failed on rank {rank} of {nranks} "
                    f"({backend}):\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [got[r] for r in range(nranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def local_axis(device="cuda", timeout=300.0):
    """A world-1 process group in this process (NCCL on a CUDA device,
    gloo on the CPU) and its ``Axis``; the group is destroyed on exit."""
    import torch.distributed as dist

    devices, backend = plan(device, 1)
    tmp = tempfile.mkdtemp(prefix="eigd_ranks_")
    try:
        axis = _init(0, 1, os.path.join(tmp, "store"), devices[0], backend,
                     timeout)
        yield axis
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
