"""Geometric multigrid shift-invert factor for structured grids.

Counterpart of ``eigd_tpu/ops/multigrid.py``. The factor stores the 9-point
block stencil of A - sigma*B at every level of a coarsening hierarchy
(exact Galerkin coarse stencils by comb probing), smooths with
Jacobi-preconditioned Chebyshev, solves the coarsest level with a dense
f32 inverse, and runs the V-cycle in f32. ``mv`` solves to f64 accuracy by
flexible PCG in f64 with the f32 V-cycle as the preconditioner;
``approx_mv``/``sweep_mv`` are short f32 PCG solves for the mixed ladders.

Variants of the V-cycle:
  "kernel" - channel-plane layout, every f32 level matvec on K1 and the
             outer f64 residual on K2 (``cuda_stencil``); on CPU tensors
             the same code runs the kernels' plain twins.
  "plain"  - vector layout, plain ``stencil_matvec`` everywhere.
  "auto"   - "kernel" when the stencil lives on CUDA, else "plain".
JAX's "barrier" and "f64" variants exist only to fence an XLA:TPU
miscompile and are not ported.

The factor is used inside the eigh_gen forward and adjoint solves (never
differentiated through). The PCG loops exit on data-dependent conditions,
each a host decision (``sync.host_flags``); every exit is counted by its
reason (``sync.loop_exit``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_stencil
from .stencil import stencil_matvec
from .sync import columns, host_flags, loop_exit, span


# ---------------------------------------------------------------------------
# Grid transfer operators: bilinear prolongation and its exact transpose
# ---------------------------------------------------------------------------


def _pad_axis(t, axis, before, after):
    """Zero-pad one axis of t."""
    parts = []
    if before:
        shape = list(t.shape)
        shape[axis] = before
        parts.append(t.new_zeros(shape))
    parts.append(t)
    if after:
        shape = list(t.shape)
        shape[axis] = after
        parts.append(t.new_zeros(shape))
    return torch.cat(parts, dim=axis)


def _interp(g, axis):
    """Bilinear interpolation along one axis: n+1 -> 2n+1 points."""
    n = g.shape[axis] - 1
    shape = list(g.shape)
    shape[axis] = 2 * n + 1
    out = g.new_zeros(shape)
    idx = [slice(None)] * g.ndim
    lo = [slice(None)] * g.ndim
    hi = [slice(None)] * g.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = g
    idx[axis] = slice(1, None, 2)
    lo[axis] = slice(0, n)
    hi[axis] = slice(1, None)
    out[tuple(idx)] = 0.5 * (g[tuple(lo)] + g[tuple(hi)])
    return out


def _interp_T(g, axis):
    """Exact transpose of ``_interp`` along one axis: 2n+1 -> n+1."""
    even = [slice(None)] * g.ndim
    odd = [slice(None)] * g.ndim
    even[axis] = slice(0, None, 2)
    odd[axis] = slice(1, None, 2)
    o = g[tuple(odd)]
    return g[tuple(even)] + 0.5 * (_pad_axis(o, axis, 0, 1)
                                   + _pad_axis(o, axis, 1, 0))


def prolong_planes(g, nxc, nyc):
    """Bilinear interpolation coarse -> fine on (ndof, k, X, Y) planes."""
    return _interp(_interp(g, 2), 3)


def restrict_planes(g, nxc, nyc):
    """Exact transpose of ``prolong_planes``."""
    return _interp_T(_interp_T(g, 3), 2)


def prolong(xc, nxc, nyc, ndof):
    """Bilinear interpolation coarse -> fine; xc is (nc,) or (nc, k).

    Coarse grid (nxc+1, nyc+1) -> fine grid (2*nxc+1, 2*nyc+1); fine node
    (2I, 2J) is the coarse node (I, J), odd fine nodes average their coarse
    neighbours.
    """
    squeeze = xc.ndim == 1
    if squeeze:
        xc = xc[:, None]
    k = xc.shape[1]
    g = xc.reshape(nxc + 1, nyc + 1, ndof, k)
    gf = _interp(_interp(g, 0), 1)
    out = gf.reshape(-1, k)
    return out[:, 0] if squeeze else out


def restrict(yf, nxc, nyc, ndof):
    """Exact transpose of ``prolong`` (full weighting)."""
    squeeze = yf.ndim == 1
    if squeeze:
        yf = yf[:, None]
    k = yf.shape[1]
    g = yf.reshape(2 * nxc + 1, 2 * nyc + 1, ndof, k)
    gc = _interp_T(_interp_T(g, 1), 0)
    out = gc.reshape(-1, k)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Exact Galerkin coarse stencil via comb probing
# ---------------------------------------------------------------------------


def galerkin_coarse_stencil(Wf, nxf, nyf, ndof):
    """Coarse 9-point block stencil of A_c = P^T A_f P, exactly.

    For each of 16 coarse-phase classes (p, q) and each dof b, the comb
    vector with ones at coarse nodes (I = p mod 4, J = q mod 4, dof b) is
    pushed through P -> A_f -> P^T; since the coarse stencil reaches only
    +-1 coarse node and the comb stride is 4, every coarse entry reads off
    exactly one stencil block.
    """
    nxc, nyc = nxf // 2, nyf // 2
    dtype, dev = Wf.dtype, Wf.device
    Ic = np.arange(nxc + 1)
    Jc = np.arange(nyc + 1)

    probes = []
    for p in range(4):
        for q in range(4):
            for b in range(ndof):
                comb = np.zeros((nxc + 1, nyc + 1, ndof), dtype=bool)
                comb[np.ix_(Ic[Ic % 4 == p], Jc[Jc % 4 == q], [b])] = True
                probes.append(comb.reshape(-1))
    combs = torch.as_tensor(np.stack(probes, axis=1), dtype=dtype,
                            device=dev)

    u = restrict(stencil_matvec(Wf, prolong(combs, nxc, nyc, ndof),
                                nxf, nyf, ndof), nxc, nyc, ndof)
    U = u.reshape(nxc + 1, nyc + 1, ndof, 4, 4, ndof)  # [I, J, a, p, q, b]

    Wc = Wf.new_zeros((nxc + 1, nyc + 1, 3, 3, ndof, ndof))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            MI = torch.as_tensor(
                (np.arange(4)[:, None] == (Ic + di) % 4)
                & (Ic + di >= 0)[None, :] & (Ic + di <= nxc)[None, :],
                dtype=dtype, device=dev)
            MJ = torch.as_tensor(np.arange(4)[:, None] == (Jc + dj) % 4,
                                 dtype=dtype, device=dev)
            blk = torch.einsum("IJapqb,pI,qJ->IJab", U, MI, MJ)
            valid_j = torch.as_tensor((Jc + dj >= 0) & (Jc + dj <= nyc),
                                      dtype=dtype, device=dev)
            Wc[:, :, 1 + di, 1 + dj] = blk * valid_j[None, :, None, None]
    return Wc


def stencil_to_dense(W, nx, ny, ndof):
    """Dense matrix of a 9-point block stencil (coarse solve / tests only)."""
    n = (nx + 1) * (ny + 1) * ndof
    A = W.new_zeros((n, n))
    node = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i0, i1 = max(0, -di), min(nx + 1, nx + 1 - di)
            j0, j1 = max(0, -dj), min(ny + 1, ny + 1 - dj)
            rows = node[i0:i1, j0:j1]
            colsn = node[i0 + di:i1 + di, j0 + dj:j1 + dj]
            blk = W[i0:i1, j0:j1, 1 + di, 1 + dj]  # (., ., ndof, ndof)
            r = (ndof * rows[:, :, None, None]
                 + np.arange(ndof)[None, None, :, None])
            c = (ndof * colsn[:, :, None, None]
                 + np.arange(ndof)[None, None, None, :])
            r, c = np.broadcast_arrays(r, c)
            A = A.index_put((torch.as_tensor(r.reshape(-1), device=W.device),
                             torch.as_tensor(c.reshape(-1), device=W.device)),
                            blk.reshape(-1), accumulate=True)
    return A


# ---------------------------------------------------------------------------
# Chebyshev smoother (pointwise-Jacobi preconditioned)
# ---------------------------------------------------------------------------


def estimate_lmax(W, dinv, nx, ny, ndof, iters=12, generator=None):
    """lambda_max(D^-1 A) by power iteration (build time).

    The start vector is uniform on [-1, 1), drawn on the CPU from
    ``generator`` (default: a fresh ``torch.Generator`` seeded with 7) and
    moved to W's device, so CPU and CUDA builds start alike. JAX draws it
    from ``PRNGKey(7)``, which gives other numbers: 12 power steps leave
    lambda_max dependent on the start vector, so parity tests carry JAX's
    built factor across (``interop.mg_factor_from_numpy``).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(7)
    n = (nx + 1) * (ny + 1) * ndof
    v = (2.0 * torch.rand(n, generator=generator, dtype=torch.float64)
         - 1.0).to(device=W.device, dtype=W.dtype)
    for _ in range(iters):
        w = dinv * stencil_matvec(W, v, nx, ny, ndof)
        v = w / torch.sqrt(torch.sum(w * w))
    w = dinv * stencil_matvec(W, v, nx, ny, ndof)
    return torch.sum(v * w) / torch.sum(v * v)


def _cheb_coeffs(lmax, degree, lo_frac=0.25):
    """Chebyshev scalars (theta, delta, sigma1, [rho_1..]) computed in f32
    on the host, as JAX computes them from its f32 lambda_max."""
    f = np.float32
    lmax = f(lmax)
    lmin = f(lo_frac) * lmax
    lmax = f(1.02) * lmax
    theta = f(0.5) * (lmax + lmin)
    delta = f(0.5) * (lmax - lmin)
    sigma1 = theta / delta
    rho = f(1.0) / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = f(1.0) / (f(2.0) * sigma1 - rho)
        steps.append((float(rho_new * rho), float(f(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


def cheb_smooth(W, dinv, lmax, x, b, nx, ny, ndof, degree=3, lo_frac=0.25):
    """Chebyshev iteration for D^-1 A on [lo_frac*lmax, 1.02*lmax] in the
    vector layout; x=None means a zero initial iterate."""
    theta, steps = _cheb_coeffs(lmax, degree, lo_frac)
    dv = dinv[:, None] if b.ndim == 2 else dinv
    r = b if x is None else b - stencil_matvec(W, x, nx, ny, ndof)
    d = dv * r / theta
    x = d if x is None else x + d
    for c1, c2 in steps:
        r = b - stencil_matvec(W, x, nx, ny, ndof)
        d = c1 * d + c2 * (dv * r)
        x = x + d
    return x


def cheb_smooth_planes(mv, dinvp, lmax, x, b, degree=3, lo_frac=0.25):
    """Chebyshev smoother in channel-plane layout; ``mv`` is the level
    matvec on (ndof, k, X, Y) planes, ``dinvp`` the Jacobi diagonal inverse
    as (ndof, 1, X, Y). ``x=None`` means a zero initial iterate."""
    theta, steps = _cheb_coeffs(lmax, degree, lo_frac)
    r = b if x is None else b - mv(x)
    d = dinvp * r / theta
    x = d if x is None else x + d
    for c1, c2 in steps:
        r = b - mv(x)
        d = c1 * d + c2 * (dinvp * r)
        x = x + d
    return x


# ---------------------------------------------------------------------------
# Flexible PCG
# ---------------------------------------------------------------------------


def flexible_pcg(bb, mv, precond, rtol, maxiter, stag_bad, site, x0=None,
                 sums=None):
    """Flexible PCG on the columns of bb, axis 1 of (n, k) vectors or of
    (ndof, k, X, Y) planes: residuals and updates in bb.dtype, ``precond``
    the f32 V-cycle. Converged columns freeze (alpha zeroed); the SPD guard
    takes the unpreconditioned direction for a column whose V-cycle output
    is not a descent direction. The loop ends when every column is under
    ``rtol`` of its ||b|| (also from a warm start x0), after ``stag_bad``
    iterations without a 10% gain on the best total residual, or at
    ``maxiter``: one host decision an iteration (``host_flags`` at
    ``site``). ``sums(*pairs)`` gives the per-column sums of a * b for
    each pair (a, b): local by default, one all-reduce on a sharded factor.

    Returns (x, info) with info = dict(niter, res2 = per-column final
    squared residuals, tol2).
    """
    dtype = bb.dtype
    col = (1, -1) + (1,) * (bb.ndim - 2)  # a per-column value, broadcast
    if sums is None:
        dims = tuple(d for d in range(bb.ndim) if d != 1)

        def sums(*pairs):
            return [torch.sum(a * b, dim=dims) for a, b in pairs]

    def M(r, r_old=None):
        """(z, r.z, r.r[, r_old.z]) under the guard, from one ``sums``
        call: where it takes r for z, r.r for r.z and r_old.r for r_old.z."""
        z = precond(r).to(dtype)
        pairs = ((r, z), (r, r))
        if r_old is not None:
            pairs += ((r_old, z), (r_old, r))
        s = sums(*pairs)
        ok = s[0] > 0.0
        out = [torch.where(ok.view(col), z, r), torch.where(ok, s[0], s[1]),
               s[1]]
        if r_old is not None:
            out.append(torch.where(ok, s[2], s[3]))
        return out

    b2, = sums((bb, bb))
    tol2 = (rtol * rtol) * torch.clamp(b2, min=1e-300)
    x = M(bb)[0] if x0 is None else x0.to(dtype)
    r = bb - mv(x)
    z, rz, r2 = M(r)
    p = z
    best = torch.sum(r2)
    bad = torch.zeros((), dtype=torch.int64, device=bb.device)
    k = 0
    while k < maxiter:
        unconverged, fresh = host_flags(
            torch.stack([torch.any(r2 > tol2), bad < stag_bad]), site)
        if not (unconverged and fresh):
            why = "stagnated" if unconverged else "converged"
            break
        Ap = mv(p)
        pAp, = sums((p, Ap))
        active = (r2 > tol2).to(dtype)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0),
                            0.0) * active
        x = x + p * alpha.view(col)
        r_new = r - Ap * alpha.view(col)
        z, rz_new, r2, rz_old = M(r_new, r)
        # flexible (Polak-Ribiere) beta: robust to the slightly varying f32
        # V-cycle preconditioner inside f64 CG
        nz = rz != 0.0
        beta = torch.where(nz, (rz_new - rz_old) / torch.where(nz, rz, 1.0),
                           0.0)
        p = z + p * beta.view(col)
        improving = torch.sum(r2) < 0.9 * best
        bad = torch.where(improving, 0, bad + 1)
        best = torch.minimum(best, torch.sum(r2))
        r, rz = r_new, rz_new
        k += 1
    else:
        why = "maxiter"
    loop_exit(site, why, k)
    return x, {"niter": k, "res2": r2, "tol2": tol2}


# ---------------------------------------------------------------------------
# The factor
# ---------------------------------------------------------------------------


class GridMGFactor:
    """apply(x) = A^-1 x for a 9-point block-stencil SPD A, via PCG with a
    geometric-multigrid V-cycle preconditioner.

    Stored per level l: stencil W_l (f32), Jacobi diag inverse, lambda_max
    of D^-1 A (a host float); coarsest level: dense f32 inverse. ``W64``
    keeps the fine stencil in f64 for the outer f64 PCG residuals. The
    kernel variant also keeps the f32 plane stencils of every smoothed
    level (``Wps``) and the f64 fine planes (``Wp64``) the kernels read.
    """

    def __init__(self, Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                 degree=3, rtol=1e-13, maxiter=60, approx_rtol=1e-5,
                 approx_maxiter=18, stag_bad=2, vcycle="auto",
                 sweep_rtol=None, sweep_maxiter=None):
        if vcycle == "auto":
            vcycle = "kernel" if Ws[0].device.type == "cuda" else "plain"
        if vcycle not in ("kernel", "plain"):
            raise ValueError(f"Unknown vcycle variant {vcycle!r}")
        self.Ws = tuple(Ws)  # f32 stencils, fine -> coarse
        self.dinvs = tuple(dinvs)
        self.lmaxs = tuple(float(v) for v in lmaxs)
        self.coarse_inv = coarse_inv
        self.W64 = W64
        self.shapes = tuple(tuple(s) for s in shapes)
        self.ndof = ndof
        self.degree = degree
        self.rtol = rtol
        self.maxiter = maxiter
        self.approx_rtol = approx_rtol
        self.approx_maxiter = approx_maxiter
        # forward-sweep apply channel tolerances (None = the approx_* ones)
        self.sweep_rtol = sweep_rtol
        self.sweep_maxiter = sweep_maxiter
        self.stag_bad = stag_bad
        self.vcycle = vcycle
        self.Wps = self.Wp64 = None
        if vcycle == "kernel":
            # coarsest level excluded (solved densely) unless the hierarchy
            # has a single level, which is both matvec'd and solved densely
            lv = self.Ws[:-1] if len(self.Ws) > 1 else self.Ws
            self.Wps = tuple(cuda_stencil.stencil_planes(W, ndof)
                             for W in lv)
            if W64 is not None:
                self.Wp64 = cuda_stencil.stencil_planes(W64, ndof,
                                                        torch.float64)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, W, grid_shape, ndof, min_coarse=2048, degree=3,
              rtol=1e-13, maxiter=60, approx_rtol=1e-5, approx_maxiter=18,
              stag_bad=2, vcycle="auto", sweep_rtol=None,
              sweep_maxiter=None, generator=None):
        """W: fine-level stencil (f64 or f32) of the SPD shifted operator."""
        W = W.detach()
        W64 = W if W.dtype == torch.float64 else None
        Wl = W.to(torch.float32)
        nx, ny = grid_shape
        Ws, dinvs, lmaxs, shapes = [], [], [], []
        while True:
            shapes.append((nx, ny))
            Ws.append(Wl)
            dg = torch.stack([Wl[:, :, 1, 1, d, d] for d in range(ndof)],
                             dim=2).reshape(-1)
            dinv = 1.0 / dg
            dinvs.append(dinv)
            lmaxs.append(float(estimate_lmax(Wl, dinv, nx, ny, ndof,
                                             generator=generator)))
            n_cur = (nx + 1) * (ny + 1) * ndof
            can_coarsen = not (nx % 2 or ny % 2 or nx < 4 or ny < 4)
            if not can_coarsen:
                if n_cur > max(16 * min_coarse, 65536):
                    raise ValueError(
                        f"GridMGFactor: grid {nx}x{ny} cannot coarsen "
                        f"further at n={n_cur} (odd or tiny dimension); "
                        "use even element counts per level or a larger "
                        "min_coarse.")
                break
            if n_cur <= min_coarse:
                break
            Wl = galerkin_coarse_stencil(Wl, nx, ny, ndof)
            nx, ny = nx // 2, ny // 2

        Ac = stencil_to_dense(Ws[-1], *shapes[-1], ndof)
        L = torch.linalg.cholesky(Ac)
        eye = torch.eye(Ac.shape[0], dtype=Ac.dtype, device=Ac.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        coarse_inv = Linv.T @ Linv
        return cls(Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                   degree=degree, rtol=rtol, maxiter=maxiter,
                   approx_rtol=approx_rtol, approx_maxiter=approx_maxiter,
                   stag_bad=stag_bad, vcycle=vcycle, sweep_rtol=sweep_rtol,
                   sweep_maxiter=sweep_maxiter)

    # -- V-cycle -------------------------------------------------------------

    def _vcycle(self, lvl, b):
        """One plain vector-layout V-cycle at b's dtype (f32)."""
        nx, ny = self.shapes[lvl]
        if lvl == len(self.Ws) - 1:
            return self.coarse_inv @ b
        W, dinv, lmax = self.Ws[lvl], self.dinvs[lvl], self.lmaxs[lvl]
        x = cheb_smooth(W, dinv, lmax, None, b, nx, ny, self.ndof,
                        degree=self.degree)
        r = b - stencil_matvec(W, x, nx, ny, self.ndof)
        xc = self._vcycle(lvl + 1, restrict(r, nx // 2, ny // 2, self.ndof))
        x = x + prolong(xc, nx // 2, ny // 2, self.ndof)
        return cheb_smooth(W, dinv, lmax, x, b, nx, ny, self.ndof,
                           degree=self.degree)

    def _dinv_planes(self, lvl):
        nx, ny = self.shapes[lvl]
        return self.dinvs[lvl].reshape(nx + 1, ny + 1,
                                       self.ndof).permute(2, 0, 1)[:, None]

    def _vcycle_planes(self, lvl, b):
        """One f32 V-cycle in channel-plane layout ((ndof, k, X, Y)) with
        K1 level matvecs; b enters and leaves in plane layout."""
        nx, ny = self.shapes[lvl]
        nd = self.ndof
        if lvl == len(self.Ws) - 1:
            bf = cuda_stencil.from_planes(b, nx, ny, nd)
            return cuda_stencil.to_planes(self.coarse_inv @ bf, nx, ny, nd)
        Wp, lmax = self.Wps[lvl], self.lmaxs[lvl]
        dinvp = self._dinv_planes(lvl)

        def mv(xq):
            return cuda_stencil.matvec_planes(Wp, xq, nx, ny, nd)

        x = cheb_smooth_planes(mv, dinvp, lmax, None, b, degree=self.degree)
        r = b - mv(x)
        xc = self._vcycle_planes(lvl + 1,
                                 restrict_planes(r, nx // 2, ny // 2))
        x = x + prolong_planes(xc, nx // 2, ny // 2)
        return cheb_smooth_planes(mv, dinvp, lmax, x, b, degree=self.degree)

    def _apply_vcycle32(self, r):
        """One f32 V-cycle preconditioner apply on (n, k) vector-layout r."""
        if self.vcycle == "kernel":
            nx, ny = self.shapes[0]
            rq = cuda_stencil.to_planes(r.to(torch.float32), nx, ny,
                                        self.ndof)
            return cuda_stencil.from_planes(self._vcycle_planes(0, rq), nx,
                                            ny, self.ndof)
        return self._vcycle(0, r.to(torch.float32))

    # -- PCG solvers ----------------------------------------------------------

    def _pcg(self, bb, matvec, rtol, maxiter, x0=None):
        """``flexible_pcg`` on (n, k) vectors with the f32 V-cycle as the
        preconditioner; residuals and updates in bb.dtype."""
        site = "pcg_f64" if bb.dtype == torch.float64 else "pcg_f32"
        return flexible_pcg(bb, matvec, self._apply_vcycle32, rtol, maxiter,
                            self.stag_bad, site, x0=x0)

    def _pcg32(self, bb, rtol, maxiter):
        """f32 ``flexible_pcg``: the vector-layout ``_pcg`` on the plain
        variant; on the kernel variant in channel-plane layout, where the
        V-cycle and the stencil matvec both consume and produce
        (ndof, k, X, Y) planes, so the layout transposes happen once per
        solve.

        bb: (n, k) f32. Returns (x, info) in vector layout.
        """
        if self.vcycle != "kernel":
            return self._pcg(bb, self._matvec32, rtol, maxiter)
        nx, ny = self.shapes[0]
        nd = self.ndof

        def mv(xq):
            return cuda_stencil.matvec_planes(self.Wps[0], xq, nx, ny, nd)

        x, info = flexible_pcg(cuda_stencil.to_planes(bb, nx, ny, nd), mv,
                               lambda rq: self._vcycle_planes(0, rq), rtol,
                               maxiter, self.stag_bad, "pcg_f32_planes")
        return cuda_stencil.from_planes(x, nx, ny, nd), info

    def _matvec64(self, x):
        nx, ny = self.shapes[0]
        if self.Wp64 is not None:
            return cuda_stencil.stencil_matvec64(self.Wp64, x, nx, ny,
                                                 self.ndof)
        return stencil_matvec(self.W64, x, nx, ny, self.ndof)

    def _matvec32(self, x):
        nx, ny = self.shapes[0]
        if self.vcycle == "kernel":
            return cuda_stencil.stencil_matvec32(self.Wps[0], x, nx, ny,
                                                 self.ndof)
        return stencil_matvec(self.Ws[0], x, nx, ny, self.ndof)

    @property
    def shape(self):
        nx, ny = self.shapes[0]
        n = (nx + 1) * (ny + 1) * self.ndof
        return (n, n)

    @property
    def dtype(self):
        return torch.float64 if self.W64 is not None else torch.float32

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        """Solve A y = x to ~rtol in the operator's working dtype (f64: PCG
        in f64 with the f32 V-cycle as the preconditioner)."""
        y, _ = self.mv_info(x)
        return y

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)

    @span("eigd.factor.apply", work=columns)
    def mv_info(self, x, x0=None):
        """Like ``mv`` but also returns the inner-PCG convergence info
        (niter, per-column final squared residuals, tol2)."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
            x0 = None if x0 is None else x0[:, None]
        if self.W64 is None:
            rt = max(self.rtol, 1e-6)
            if x0 is None:
                y, info = self._pcg32(x.to(torch.float32), rt, self.maxiter)
            else:
                y, info = self._pcg(x.to(torch.float32), self._matvec32, rt,
                                    self.maxiter, x0=x0)
        else:
            # JAX raises rtol to 2e-13 when its double-float TPU kernel
            # computes the residual (that kernel floors near 1e-12); K2 is
            # native FP64 with no such floor, so the gate is self.rtol, the
            # JAX plain-path semantics.
            y, info = self._pcg(x.to(torch.float64), self._matvec64,
                                self.rtol, self.maxiter, x0=x0)
        return (y[:, 0] if squeeze else y), info

    @span("eigd.factor.apply", work=columns)
    def mv_warm(self, x, x0):
        """Accurate solve with a warm-start iterate (see ``flexible_pcg``)."""
        y, _ = self.mv_info(x, x0=x0)
        return y

    def _solve32(self, x, rtol, maxiter):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y, _ = self._pcg32(x.to(torch.float32), rtol, maxiter)
        return y[:, 0] if squeeze else y

    @span("eigd.factor.apply", work=columns)
    def approx_mv(self, x):
        """Preconditioner-quality f32 solve for mixed-precision ladders."""
        return self._solve32(x, self.approx_rtol, self.approx_maxiter)

    @span("eigd.factor.apply", work=columns)
    def sweep_mv(self, x):
        """Forward-sweep apply channel: the f32 solve at (sweep_rtol,
        sweep_maxiter), each defaulting to its approx_* value."""
        rt = self.approx_rtol if self.sweep_rtol is None else self.sweep_rtol
        mi = (self.approx_maxiter if self.sweep_maxiter is None
              else self.sweep_maxiter)
        return self._solve32(x, rt, mi)

    @span("eigd.factor.apply", work=columns)
    def precond_mv(self, x):
        """ONE f32 V-cycle: the raw preconditioner apply."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y = self._apply_vcycle32(x).to(self.dtype)
        return y[:, 0] if squeeze else y
