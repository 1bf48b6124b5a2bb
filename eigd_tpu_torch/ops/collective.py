"""Reductions and exchanges over the DOF dimension.

Counterpart of ``eigd_tpu/ops/collective.py:19-28,243``. Every solver
takes an ``axis``: ``None`` is the single-device path (plain products,
bitwise what it was before the sharded solve existed); an ``Axis`` names a
``torch.distributed`` process group over whose ranks the DOF dimension of
every long vector is sharded, the counterpart of a ``shard_map`` mesh-axis
name. Each inner product is then a local contraction and an all-reduce.

The JAX package's double-float GEMMs (``dd_dot``, ``dd_dot_rowsT``,
``dd_mul_small``) exist because XLA:TPU emulates f64; on the CPU JAX
already takes them as plain f64 products, and Hopper has native FP64, so
the port writes them as plain ``@``. ``chunked_dot_f32`` stays: it is the
f32 re-orthogonalization sweep of the local-ortho block Lanczos, not a
workaround.

Autograd across ranks. Every rank computes the same replicated scalar and
calls ``backward()`` on it, so a replicated value's cotangent is whole on
every rank and a sharded value's cotangent is that of the rank's shard.
Hence ``psum``'s backward is the identity (JAX's shard_map pairs psum with
a broadcast in the transpose; an all-reduce there would multiply the
gradient by the rank count), ``ppermute``'s is the inverse permutation,
``all_gather``'s takes the rank's slice, and ``shard`` (a replicated array
-> the rank's slice) and ``pvary`` (a replicated array read by
rank-dependent work) all-reduce the cotangent, so that a replicated
input's gradient is whole and equal on every rank. ``ppermute`` also has a
forward-mode rule (the tangent of the sharded eigensolve).

Backends. NCCL takes CUDA tensors for every collective here but refuses
two ranks on one device. Gloo takes CPU tensors for all of them; with
CUDA tensors it takes ``all_reduce``, ``broadcast`` and ``all_gather``
but not point-to-point sends (``python -m eigd_tpu_torch.diag.backends``
on an H100 with torch 2.11: send/recv fails, the rest return the right
values). So an ``Axis`` on gloo with CUDA tensors stages ``ppermute``
through host buffers (``Axis.staged``); the compute stays on the device.
"""

from __future__ import annotations

import torch


class Axis:
    """The shard axis: a process group, this process's rank in it, the
    group's size, the device the shards live on and the backend's name.

    group=None is the default group (``torch.distributed.init_process_group``
    must have run). ``staged`` is true where the backend cannot send the
    device's tensors point to point (gloo with CUDA tensors): ppermute
    then goes through host buffers.
    """

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if self.backend == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    def global_rank(self, r):
        """The default-group rank of group rank r."""
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def __repr__(self):
        return (f"Axis(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={str(self.device)!r}, "
                f"staged={self.staged})")


def axis_index(axis):
    """This rank's index on the axis (``jax.lax.axis_index``; 0 without
    one)."""
    return 0 if axis is None else axis.rank


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)
# ---------------------------------------------------------------------------


def _all_reduce(x, axis):
    import torch.distributed as dist

    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


def _ppermute_multi(pairs, axis):
    """One ``_ppermute`` for each (x, perm) of ``pairs``, their sends and
    receives posted in one batch; the list of results."""
    import torch.distributed as dist

    host = torch.device("cpu") if axis.staged else None
    ops, outs = [], []
    for x, perm in pairs:
        x = x.detach()
        sends = [dst for src, dst in perm if src == axis.rank]
        recvs = [src for src, dst in perm if dst == axis.rank]
        dev = host or x.device
        out = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        if sends:
            xs = x.to(dev).contiguous()
            ops += [dist.P2POp(dist.isend, xs, axis.global_rank(d),
                               axis.group) for d in sends]
        ops += [dist.P2POp(dist.irecv, out, axis.global_rank(r), axis.group)
                for r in recvs]
        outs.append((out, x.device))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [out.to(dev) for out, dev in outs]


def _ppermute(x, axis, perm):
    """y = x of the rank that sends here under ``perm`` ((src, dst) pairs
    of group ranks), zeros where no rank sends (``jax.lax.ppermute``)."""
    return _ppermute_multi([(x, perm)], axis)[0]


def _all_gather(x, axis, dim=0):
    """The ranks' x concatenated along ``dim`` in rank order."""
    import torch.distributed as dist

    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, dx, _axis):
        return _all_reduce(dx, ctx.axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, perm):
        return _ppermute(x, axis, perm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.perm = inputs

    @staticmethod
    def backward(ctx, g):
        inv = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(g, ctx.axis, inv), None, None

    @staticmethod
    def jvp(ctx, dx, _axis, _perm):
        return _ppermute(dx, ctx.axis, ctx.perm)


class _PPermuteMulti(torch.autograd.Function):
    @staticmethod
    def forward(axis, perms, *xs):
        return tuple(_ppermute_multi(list(zip(xs, perms)), axis))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.perms = inputs[0], inputs[1]
        ctx.meta = [(x.shape, x.dtype, x.device) for x in inputs[2:]]

    @staticmethod
    def backward(ctx, *gs):
        inv = [tuple((dst, src) for src, dst in p) for p in ctx.perms]
        return (None, None, *_ppermute_multi(list(zip(gs, inv)), ctx.axis))

    @staticmethod
    def jvp(ctx, _axis, _perms, *dxs):
        dxs = [torch.zeros(m[0], dtype=m[1], device=m[2]) if d is None
               else d for d, m in zip(dxs, ctx.meta)]
        return tuple(_ppermute_multi(list(zip(dxs, ctx.perms)), ctx.axis))


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, dx, _axis):
        return dx


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _all_gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, ctx.dim = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, n_local):
        return x.narrow(0, axis.rank * n_local, n_local).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, ctx.n_local = inputs
        ctx.shape = x.shape

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(0, ctx.axis.rank * ctx.n_local, ctx.n_local).copy_(g)
        return _all_reduce(full, ctx.axis), None, None


def psum(x, axis=None):
    """Sum over the shard axis: the identity without one. Its backward is
    the identity (the sum is used replicated)."""
    if axis is None:
        return x
    return _Psum.apply(x, axis)


def pdot(x, y, axis=None):
    """Inner product / contraction over the (possibly sharded) DOF dim."""
    return psum(x @ y, axis)


def col_sums(axis):
    """The PCG loops' ``sums`` over sharded (n, k) blocks: for each pair
    (a, b) the column sums of a * b, one all-reduce for all pairs."""
    return lambda *pairs: psum(torch.stack(
        [torch.sum(a * b, dim=0) for a, b in pairs]), axis)


def ppermute(x, axis, perm):
    """Counterpart of ``jax.lax.ppermute``: each (src, dst) pair of
    ``perm`` sends src's x to dst; a rank no pair sends to gets zeros."""
    return _PPermute.apply(x, axis, tuple((int(s), int(d)) for s, d in perm))


def ppermute_multi(pairs, axis):
    """``ppermute`` of each (x, perm) of ``pairs``, the sends and receives
    posted in one batch (and the backward's likewise); the list of
    results."""
    perms = tuple(tuple((int(s), int(d)) for s, d in p) for _, p in pairs)
    return list(_PPermuteMulti.apply(axis, perms, *(x for x, _ in pairs)))


def pvary(x, axis):
    """x, replicated, as an input of rank-dependent work (``jax.lax.
    pvary``): the identity, whose backward all-reduces the cotangent, so
    that x's gradient is whole and equal on every rank."""
    if not x.requires_grad:
        return x
    return _PVary.apply(x, axis)


def all_gather(x, axis, dim=0):
    """The ranks' x concatenated along ``dim`` (``jax.lax.all_gather``
    with ``tiled=True``), replicated on every rank."""
    return _AllGather.apply(x, axis, dim)


def shard(x, axis, n_local):
    """Rows [rank*n_local, (rank+1)*n_local) of a replicated x; the
    backward all-reduces the cotangent, so x's gradient is whole on every
    rank."""
    return _Shard.apply(x, axis, n_local)


# ---------------------------------------------------------------------------
# Contractions
# ---------------------------------------------------------------------------


def chunked_dot_f32(X, w, axis=None, chunk=8192):
    """(m, n) @ (n, p) in f32 with f64 accumulation across n-chunks, summed
    over the shard axis.

    A plain f32 product over large n accumulates rounding ~ n*eps32;
    contracting each ``chunk`` in f32 and summing the partials in f64 bounds
    it at the chunk's while keeping the f32 rate.
    """
    X = X.to(torch.float32)
    w = w.to(torch.float32)
    m, n = X.shape
    p = w.shape[1]
    nch = n // chunk
    if nch < 2:
        return psum((X @ w).to(torch.float64), axis)
    n_main = nch * chunk
    Xr = X[:, :n_main].reshape(m, nch, chunk).transpose(0, 1)
    wr = w[:n_main].reshape(nch, chunk, p)
    out = torch.bmm(Xr, wr).to(torch.float64).sum(dim=0)
    if n_main < n:
        out = out + (X[:, n_main:] @ w[n_main:]).to(torch.float64)
    return psum(out, axis)


def qr_tall(R, axis=None):
    """Thin QR of a tall (n, k) block, DOF-sharded over ``axis``.

    axis=None: ``torch.linalg.qr``. Sharded: JAX's CholeskyQR2, the column
    scaling first (adjoint residual blocks mix converged and active
    columns), the Gram matrix one all-reduced GEMM, its Cholesky with a
    50*eps diagonal regularization replicated, and a second pass that
    restores orthogonality.
    """
    if axis is None:
        return torch.linalg.qr(R)
    eps = 50.0 * float(torch.finfo(R.dtype).eps)

    def chol(G):
        eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        return torch.linalg.cholesky(G + eps * eye)

    def solve(L, X):  # X L^-T, from the right
        return torch.linalg.solve_triangular(L.T, X, upper=True, left=False)

    cn = torch.sqrt(psum(torch.sum(R * R, dim=0), axis))
    s = torch.where(cn > 0.0, cn, 1.0)
    Rs = R / s[None, :]
    L = chol(psum(Rs.T @ Rs, axis))
    Q = solve(L, Rs)
    r1 = L.T * s[None, :]
    L2 = chol(psum(Q.T @ Q, axis))
    Q = solve(L2, Q)
    return Q, L2.T @ r1
