"""What each torch.distributed backend takes on this machine's device,
and what its collectives cost there.

For NCCL at world 1 and gloo at world 2 (two ranks sharing one card, as
chip_smoke's ``[sharded4]`` runs four) each collective the sharded solve
uses is tried directly on CUDA tensors, without the host staging of
``collective.Axis.staged``: all_reduce, broadcast, all_gather and
send/recv (``batch_isend_irecv``). Each line says "ok" and whether the
result is right, or the error the backend raised. A probe that hangs is
ended by the launcher's deadline and reported as such. Then, at 2 and 4
gloo ranks sharing the card, the milliseconds per operation (rank 0, the
mean over 300 after 5 warm-ups) of: gloo's all_reduce and all_gather of
CUDA tensors (``collective.psum`` and ``all_gather`` on a staged axis),
its all_reduce of a host tensor, the staged ``collective.ppermute``, a
point-to-point send of a host tensor, a device-to-host copy, and a tiny
kernel followed by a synchronize (the card's time-slicing between the
ranks' processes).

    python -m eigd_tpu_torch.diag.backends
"""

from __future__ import annotations

import time

import torch


def probe(axis):
    """{op: "ok" / "wrong" / the error} for each collective on CUDA
    tensors of the axis's device, unstaged."""
    import torch.distributed as dist

    r, n = axis.rank, axis.size
    x = torch.full((4,), float(r + 1), device=axis.device)
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize(axis.device)
            out[name] = "ok" if torch.equal(got.cpu(), want) else "wrong"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def send_recv():
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (r + 1) % n),
               dist.P2POp(dist.irecv, y, (r - 1) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return y

    tot = float(sum(range(1, n + 1)))
    attempt("all_reduce", all_reduce, torch.full((4,), tot))
    attempt("broadcast", broadcast, torch.full((4,), 1.0))
    attempt("all_gather", all_gather, torch.cat(
        [torch.full((4,), float(d + 1)) for d in range(n)]))
    if n > 1:
        attempt("send/recv", send_recv, torch.full((4,), float((r - 1) % n
                                                                + 1)))
    return out


def latency(axis, reps=300):
    """{operation: ms per call on rank 0} on the axis (see the module
    docstring)."""
    import torch.distributed as dist

    from ..ops import collective as col

    dev = axis.device
    x = torch.randn(200, 3, dtype=torch.float64, device=dev)
    s = x[0]
    chain = [(d, d + 1) for d in range(axis.size - 1)]
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        for _ in range(5):
            fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        out[name] = (time.perf_counter() - t0) / reps * 1e3

    def gloo_cuda_all_reduce():
        y = s.clone()
        dist.all_reduce(y)

    def gloo_cuda_all_gather():
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x)

    def gloo_host_all_reduce():
        dist.all_reduce(s.cpu())

    def host_send():
        col._ppermute_multi([(x.cpu(), chain)], _Unstaged(axis))

    timed("tiny kernel + synchronize", lambda: (s.add_(0.0), sync()))
    timed("device-to-host copy (4.8 kB)", lambda: x.cpu())
    timed("gloo all_reduce of a device tensor (3 numbers)",
          gloo_cuda_all_reduce)
    timed("gloo all_reduce of a host tensor (3 numbers)",
          gloo_host_all_reduce)
    timed("gloo all_gather of a device tensor (4.8 kB)",
          gloo_cuda_all_gather)
    timed("staged ppermute (collective.ppermute)",
          lambda: col.ppermute(x, axis, chain))
    timed("send/recv of a host tensor", host_send)
    return out


class _Unstaged:
    """The axis's group as an unstaged axis (host tensors)."""

    def __init__(self, axis):
        self.rank, self.size, self.group = axis.rank, axis.size, axis.group
        self.staged = False
        self.global_rank = axis.global_rank


def main():
    from . import common
    from ..parallel import launch

    common.require_cuda()
    print(common.card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    with launch.local_axis("cuda") as axis:
        res = probe(axis)
    for op, v in res.items():
        print(f"[backends] nccl world 1 cuda:0 {op}: {v}")
    try:
        res = launch.run(probe, 2, device="cuda:0", timeout=120.0)[0]
    except TimeoutError as e:
        res = {"all": f"hung: {e}"}
    for op, v in res.items():
        print(f"[backends] gloo world 2 sharing cuda:0 {op}: {v}")
    for n in (2, 4):
        res = launch.run(latency, n, device="cuda:0", timeout=300.0)[0]
        for op, ms in res.items():
            print(f"[latency] {n} gloo ranks sharing cuda:0: {op}: "
                  f"{ms:.3f} ms")


if __name__ == "__main__":
    main()
