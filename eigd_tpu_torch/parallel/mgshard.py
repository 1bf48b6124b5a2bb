"""Line-sharded geometric multigrid shift-invert factor.

Counterpart of ``eigd_tpu/parallel/mgshard.py``. The DOF vectors are
sharded over node lines (``grid.GridPartition``): rank r owns fine lines
[r*L, (r+1)*L). A stencil matvec needs one halo line from each neighbour;
with L even per sharded level, restriction needs one left fine halo line
and prolongation one right coarse halo line, so the grid transfers stay
rank-local. The top ``shard_levels`` levels run sharded; below them the
coarse residual is all-gathered and the rest of the hierarchy runs
replicated through a serial ``GridMGFactor``. The hierarchy is built
replicated from one all-gather of the fine stencil (Galerkin probing,
Jacobi diagonals and lambda_max estimates reuse ``ops.multigrid``); each
rank keeps the stencil of its own lines plus one halo line each side.

The V-cycle stays in the channel-plane layout (ndof, k, X, Y) of the
serial kernel V-cycle, X the rank's lines, so a halo is the first or last
X-plane. Every level matvec is a stencil matvec on the rank's extended
grid of L+2 lines (zero stencil on padded lines): K1 (``cuda_stencil.
matvec_planes``) for the f32 smoother and residual, and K2
(``stencil_matvec64``) for the f64 outer-PCG residual. On CPU tensors the
same calls run the kernels' plain twins.

``mv`` is flexible PCG in f64 with all-reduced inner products and the f32
V-cycle as preconditioner; ``precond_mv`` is one raw V-cycle (the mixed
pcpg adjoint), ``approx_mv`` a short f32 PCG. Every PCG decision reads
all-reduced values, so all ranks leave their loops together.
"""

from __future__ import annotations

import torch

from ..ops import cuda_stencil
from ..ops.collective import (all_gather, col_sums, ppermute,
                              ppermute_multi, pvary)
from ..ops.multigrid import (GridMGFactor, _cheb_coeffs, estimate_lmax,
                             flexible_pcg, galerkin_coarse_stencil)
from ..ops.stencil import stencil_matvec


def _fwd(n):
    return [(d, d + 1) for d in range(n - 1)]  # my last line -> right


def _bwd(n):
    return [(d + 1, d) for d in range(n - 1)]  # my first line -> left


def _halo_lines(first, last, axis):
    """(left, right) halo lines: the left neighbour's ``last`` and the
    right neighbour's ``first`` (zeros at the global boundary), exchanged
    in one batch."""
    if axis.size == 1:
        return torch.zeros_like(last), torch.zeros_like(first)
    return ppermute_multi([(last, _fwd(axis.size)),
                           (first, _bwd(axis.size))], axis)


def _extend(xg, axis, dim):
    """xg with the two halo lines concatenated along ``dim``."""
    left, right = _halo_lines(xg.narrow(dim, 0, 1),
                              xg.narrow(dim, xg.shape[dim] - 1, 1), axis)
    return torch.cat([left, xg, right], dim=dim)


def local_stencil(W_rep, L, axis):
    """Lines [r*L - 1, r*L + L + 1) of the replicated line-padded stencil
    (zero outside it): the stencil of the rank's extended grid."""
    W_rep = pvary(W_rep, axis)
    pad = W_rep.new_zeros((1,) + tuple(W_rep.shape[1:]))
    Wp = torch.cat([pad, W_rep, pad])
    return Wp[axis.rank * L: axis.rank * L + L + 2]


def sharded_stencil_matvec(W_rep, x, L, nlines, ny, ndof, axis):
    """Local shard of the global stencil matvec, vector layout.

    W_rep : replicated (ndev*L, ny+1, 3, 3, ndof, ndof) stencil, zero on
        padded lines. x : (L*(ny+1)*ndof,) or (., k) local lines. The
        matvec on the rank's extended grid: K2 (f64) or K1 (f32) on a CUDA
        x, the plain stencil matvec on a CPU one, and on any device where
        a gradient is asked for (grad mode on and W_rep or x requiring
        grad): the kernels have no autograd rule, and JAX's function
        always differentiates. (``nlines`` is JAX's argument, unused there
        too.)
    """
    del nlines
    grad = torch.is_grad_enabled() and (W_rep.requires_grad
                                        or x.requires_grad)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    w = (ny + 1) * ndof
    x_ext = _extend(x.reshape(L, w, k), axis, 0).reshape((L + 2) * w, k)
    W_ext = local_stencil(W_rep, L, axis)
    if x.is_cpu or grad:
        y = stencil_matvec(W_ext, x_ext, L + 1, ny, ndof)
    elif x.dtype == torch.float64:
        y = cuda_stencil.stencil_matvec64(cuda_stencil.stencil_planes(
            W_ext, ndof, torch.float64), x_ext, L + 1, ny, ndof)
    else:
        y = cuda_stencil.stencil_matvec32(cuda_stencil.stencil_planes(
            W_ext, ndof), x_ext, L + 1, ny, ndof)
    out = y[w:(L + 1) * w]
    return out[:, 0] if squeeze else out


def _vec_to_planes(x, L, ny, ndof):
    return cuda_stencil.to_planes(x, L - 1, ny, ndof)


def _planes_to_vec(xq, L, ny, ndof):
    return cuda_stencil.from_planes(xq, L - 1, ny, ndof)


def restrict_planes(g, axis):
    """Full-weighting restriction of line-sharded fine planes
    (ndof, k, Lf, ny+1) -> local coarse planes (ndof, k, Lf/2, ny/2+1);
    one left fine halo line."""
    Lc = g.shape[2] // 2
    o = g[..., 1::2]
    z = o.new_zeros(o.shape[:3] + (1,))
    gj = g[..., 0::2] + 0.5 * (torch.cat([o, z], dim=3)
                               + torch.cat([z, o], dim=3))
    if axis.size == 1:
        left = torch.zeros_like(gj[:, :, -1:])
    else:
        left = ppermute(gj[:, :, -1:].contiguous(), axis, _fwd(axis.size))
    ext = torch.cat([left, gj], dim=2)  # index 0 is fine line -1
    even = ext[:, :, 1::2][:, :, :Lc]
    odd_m = ext[:, :, 0::2][:, :, :Lc]
    op = ext[:, :, 2::2]
    odd_p = torch.cat([op, op.new_zeros(op.shape[:2] + (1,) + op.shape[3:])],
                      dim=2)[:, :, :Lc]
    return even + 0.5 * (odd_m + odd_p)


def prolong_planes(xc, axis, nlines_f):
    """Bilinear prolongation of line-sharded coarse planes (ndof, k, Lc,
    nyc+1) -> local fine planes (ndof, k, 2 Lc, 2 nyc+1); one right coarse
    halo line. Fine lines at or past ``nlines_f`` (the true global count)
    are zeroed, so padding carries nothing into inner products."""
    nd, k, Lc, Yc = xc.shape
    gi = xc.new_zeros((nd, k, Lc, 2 * Yc - 1))
    gi[..., 0::2] = xc
    gi[..., 1::2] = 0.5 * (xc[..., :-1] + xc[..., 1:])
    if axis.size == 1:
        right = torch.zeros_like(gi[:, :, :1])
    else:
        right = ppermute(gi[:, :, :1].contiguous(), axis, _bwd(axis.size))
    ext = torch.cat([gi, right], dim=2)
    gf = xc.new_zeros((nd, k, 2 * Lc, 2 * Yc - 1))
    gf[:, :, 0::2] = gi
    gf[:, :, 1::2] = 0.5 * (ext[:, :, :-1] + ext[:, :, 1:])
    line = axis.rank * 2 * Lc + torch.arange(2 * Lc, device=xc.device)
    return gf * (line < nlines_f).to(gf.dtype)[None, None, :, None]


def sharded_restrict(yf, Lf, ny, ndof, axis):
    """``restrict_planes`` on the (Lf*(ny+1)*ndof,) or (., k) vector
    layout."""
    squeeze = yf.ndim == 1
    if squeeze:
        yf = yf[:, None]
    gc = restrict_planes(_vec_to_planes(yf, Lf, ny, ndof), axis)
    out = _planes_to_vec(gc, Lf // 2, ny // 2, ndof)
    return out[:, 0] if squeeze else out


def sharded_prolong(xc, Lc, nyc, ndof, axis, nlines_f):
    """``prolong_planes`` on the vector layout."""
    squeeze = xc.ndim == 1
    if squeeze:
        xc = xc[:, None]
    gf = prolong_planes(_vec_to_planes(xc, Lc, nyc, ndof), axis, nlines_f)
    out = _planes_to_vec(gf, 2 * Lc, 2 * nyc, ndof)
    return out[:, 0] if squeeze else out


class ShardedGridMGFactor:
    """Sharded-apply mirror of ``ops.multigrid.GridMGFactor``.

    levels : per sharded level (L, nlines, nx, ny, Wp, dinvp, lmax): the
        rank's lines, the true global line count, the level grid, the f32
        planes of the rank's extended stencil (9 ndof^2, L+2, ny+1), the
        Jacobi inverse of its own lines as (ndof, 1, L, ny+1) and
        lambda_max of D^-1 A.
    tail : a serial ``GridMGFactor`` over the rest of the hierarchy.
    Wp64 : the f64 planes of the rank's extended fine stencil (outer PCG).
    """

    def __init__(self, levels, tail, Wp64, axis, ndof, degree=3, rtol=1e-13,
                 maxiter=60, approx_rtol=1e-5, approx_maxiter=18, stag_bad=2):
        self.levels = tuple(levels)
        self.tail = tail
        self.Wp64 = Wp64
        self.axis = axis
        self.ndof = ndof
        self.degree = degree
        self.rtol = rtol
        self.maxiter = maxiter
        self.approx_rtol = approx_rtol
        self.approx_maxiter = approx_maxiter
        self.stag_bad = stag_bad

    @classmethod
    def build(cls, W_local, part, axis, shard_levels=2, min_coarse=2048,
              degree=3, rtol=1e-13, maxiter=60, approx_rtol=1e-5,
              approx_maxiter=18):
        """W_local : (L, ny+1, 3, 3, ndof, ndof) f64 or f32 stencil of the
        rank's fine lines (zero on padded lines); part : a GridPartition
        with L % 2**shard_levels == 0."""
        ndev, L, ndof = part.ndev, part.L, part.ndof
        nx, ny = part.nx, part.ny
        if L % (1 << shard_levels):
            raise ValueError(
                f"lines per rank L={L} must be divisible by "
                f"2**shard_levels={1 << shard_levels}")
        W_local = W_local.detach()
        Wg = all_gather(W_local, axis)  # replicated, line-padded
        Wp64 = None
        if W_local.dtype == torch.float64:
            Wp64 = cuda_stencil.stencil_planes(local_stencil(Wg, L, axis),
                                               ndof, torch.float64)
        Wl = Wg.to(torch.float32)
        levels = []
        Ll, nxl, nyl = L, nx, ny
        for lvl in range(shard_levels):
            nlines = nxl + 1
            Wtrue = Wl[:nlines]
            dg = torch.stack([Wtrue[:, :, 1, 1, d, d] for d in range(ndof)],
                             dim=2).reshape(-1)
            dinv_true = 1.0 / torch.where(dg == 0.0, 1.0, dg)
            lmax = float(estimate_lmax(Wtrue, dinv_true, nxl, nyl, ndof))
            dinv = torch.cat([dinv_true, dinv_true.new_ones(
                (ndev * Ll - nlines) * (nyl + 1) * ndof)])
            per = Ll * (nyl + 1) * ndof
            dinv = dinv[axis.rank * per:(axis.rank + 1) * per]
            dinvp = dinv.reshape(Ll, nyl + 1, ndof).permute(2, 0, 1)[:, None]
            Wp = cuda_stencil.stencil_planes(local_stencil(Wl, Ll, axis),
                                             ndof)
            levels.append((Ll, nlines, nxl, nyl, Wp, dinvp, lmax))
            Wc = galerkin_coarse_stencil(Wtrue, nxl, nyl, ndof)
            nxl, nyl = nxl // 2, nyl // 2
            if lvl < shard_levels - 1:
                Ll //= 2
                Wl = torch.cat([Wc, Wc.new_zeros(
                    (ndev * Ll - (nxl + 1),) + tuple(Wc.shape[1:]))])
        tail = GridMGFactor.build(Wc, (nxl, nyl), ndof,
                                  min_coarse=min_coarse, degree=degree)
        return cls(levels, tail, Wp64, axis, ndof, degree=degree, rtol=rtol,
                   maxiter=maxiter, approx_rtol=approx_rtol,
                   approx_maxiter=approx_maxiter)

    @property
    def shape(self):
        L, _, _, ny = self.levels[0][:4]
        n = L * (ny + 1) * self.ndof
        return (n, n)

    @property
    def dtype(self):
        return torch.float64 if self.Wp64 is not None else torch.float32

    # -- sharded V-cycle ----------------------------------------------------

    def _matvec_planes(self, lvl, xq):
        """K1 on the rank's extended grid: the level matvec on (ndof, k, L,
        ny+1) planes."""
        L, _, _, ny, Wp = self.levels[lvl][:5]
        x_ext = _extend(xq, self.axis, 2)
        y = cuda_stencil.matvec_planes(Wp, x_ext, L + 1, ny, self.ndof)
        return y[:, :, 1:L + 1]

    def _smooth(self, lvl, x, b):
        """Chebyshev on D^-1 A (``multigrid.cheb_smooth_planes``'s
        polynomial) with the sharded matvec; x=None is a zero start."""
        dinvp, lmax = self.levels[lvl][5:7]
        theta, steps = _cheb_coeffs(lmax, self.degree)
        r = b if x is None else b - self._matvec_planes(lvl, x)
        d = dinvp * r / theta
        x = d if x is None else x + d
        for c1, c2 in steps:
            r = b - self._matvec_planes(lvl, x)
            d = c1 * d + c2 * (dinvp * r)
            x = x + d
        return x

    def _tail_vcycle(self, rc, nxc, nyc):
        """All-gather the coarse residual planes, run the replicated tail,
        keep the rank's lines."""
        Lc = rc.shape[2]
        g = all_gather(rc, self.axis, dim=2)[:, :, :nxc + 1]
        if self.tail.vcycle == "kernel":
            xg = self.tail._vcycle_planes(0, g.contiguous())
        else:
            v = self.tail._vcycle(0, cuda_stencil.from_planes(
                g, nxc, nyc, self.ndof))
            xg = cuda_stencil.to_planes(v, nxc, nyc, self.ndof)
        pad = xg.new_zeros(xg.shape[:2] + (self.axis.size * Lc - nxc - 1,)
                           + xg.shape[3:])
        xg = torch.cat([xg, pad], dim=2)
        return xg[:, :, self.axis.rank * Lc:(self.axis.rank + 1) * Lc]

    def _vcycle_planes(self, lvl, b):
        """One f32 V-cycle on (ndof, k, L, ny+1) planes."""
        _, nlines, nx, ny = self.levels[lvl][:4]
        x = self._smooth(lvl, None, b)
        r = b - self._matvec_planes(lvl, x)
        rc = restrict_planes(r, self.axis)
        if lvl + 1 < len(self.levels):
            xc = self._vcycle_planes(lvl + 1, rc)
        else:
            xc = self._tail_vcycle(rc, nx // 2, ny // 2)
        x = x + prolong_planes(xc, self.axis, nlines)
        return self._smooth(lvl, x, b)

    def _vcycle(self, r):
        """One f32 V-cycle on an (n, k) vector-layout r."""
        L, _, _, ny = self.levels[0][:4]
        rq = _vec_to_planes(r.to(torch.float32), L, ny, self.ndof)
        return _planes_to_vec(self._vcycle_planes(0, rq), L, ny, self.ndof)

    # -- solves --------------------------------------------------------------

    def _ext_vec(self, x):
        L, _, _, ny = self.levels[0][:4]
        k = x.shape[1]
        w = (ny + 1) * self.ndof
        return _extend(x.reshape(L, w, k), self.axis, 0).reshape(
            (L + 2) * w, k), w, L

    def _matvec64(self, x):
        """K2 on the rank's extended fine grid, vector layout."""
        ny = self.levels[0][3]
        xe, w, L = self._ext_vec(x)
        y = cuda_stencil.stencil_matvec64(self.Wp64, xe, L + 1, ny, self.ndof)
        return y[w:(L + 1) * w]

    def _matvec32(self, x):
        """K1 on the rank's extended fine grid, vector layout."""
        ny, Wp = self.levels[0][3], self.levels[0][4]
        xe, w, L = self._ext_vec(x)
        y = cuda_stencil.stencil_matvec32(Wp, xe, L + 1, ny, self.ndof)
        return y[w:(L + 1) * w]

    def _solve(self, x, f64, rtol, maxiter):
        """``ops.multigrid.flexible_pcg`` (f64 or f32) with the sharded
        V-cycle as the preconditioner and its column sums all-reduced, each
        call's sums in one all-reduce: two an iteration. Every loop
        decision reads replicated values, so all ranks leave the loop
        together."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        dtype, matvec, site = ((torch.float64, self._matvec64, "mgshard_f64")
                               if f64 else
                               (torch.float32, self._matvec32, "mgshard_f32"))
        y, _ = flexible_pcg(x.to(dtype), matvec, self._vcycle, rtol, maxiter,
                            self.stag_bad, site, sums=col_sums(self.axis))
        return y[:, 0] if squeeze else y

    def mv(self, x):
        """Solve A y = x: f64 PCG to ``rtol`` (f32 to max(rtol, 1e-6) when
        the factor holds no f64 stencil)."""
        if self.Wp64 is None:
            return self._solve(x, False, max(self.rtol, 1e-6), self.maxiter)
        return self._solve(x, True, self.rtol, self.maxiter)

    def __call__(self, x):
        return self.mv(x)

    def approx_mv(self, x):
        """Preconditioner-quality f32 solve (mixed-precision ladders)."""
        return self._solve(x, False, self.approx_rtol, self.approx_maxiter)

    def precond_mv(self, x):
        """ONE sharded f32 V-cycle."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y = self._vcycle(x).to(self.dtype)
        return y[:, 0] if squeeze else y
