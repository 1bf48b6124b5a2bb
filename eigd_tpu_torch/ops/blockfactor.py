"""Block-tridiagonal factors for structured-grid problems.

Counterpart of ``eigd_tpu/ops/blockfactor.py``. A regular nx x ny grid
ordered line by line makes A - sigma*B block tridiagonal with dense
(b, b) blocks, b = ndof*(ny+1). The factors here are batched Cholesky,
triangular solves and GEMMs through ``torch.linalg`` (cuSOLVER and cuBLAS
on the card), as JAX's are XLA's, outside any kernel of the package:

* ``BlockTridiagFactor``: block Cholesky, one Python step per grid line
  (JAX's ``lax.scan``), applied by two sweeps of 2*nb small GEMMs. Fine on
  the CPU and in tests; host-bound at scale, where BCR takes its place.
* ``BCRFactor``: block cyclic reduction, log2(nb) levels of batched work;
  on a grid, level 0's couplings are applied through the matrix's own
  stencil (K2 on the card) instead of being stored.
* ``RefinedFactor``: an f32 factor refined to f64 accuracy against the
  matrix-free f64 operator (on the card the stencil on K2).
* ``PCGFactor``: f64 PCG preconditioned by an f32 factor of the
  equilibrated matrix, for systems whose condition defeats refinement.

The loops that JAX runs as ``while_loop`` read one decision a pass on the
host, counted in ``sync.HOST_SYNCS`` ("refine", "pcg_factor",
"pcg_factor_f32"). The Cholesky factors are taken with ``cholesky_ex``
and NaNs in place of a failed block, JAX's semantics, with no host wait.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import ElementOperator
from .sync import columns, host_flags, loop_exit, span


def grid_block_tridiag(mats, nx, ny, ndof=2):
    """Element matrices -> block-tridiagonal blocks for the line ordering.

    mats : (nx*ny, 4*ndof, 4*ndof) element matrices with element index
        e = i + nx*j and node order [(i,j), (i+1,j), (i+1,j+1), (i,j+1)]
        (``fem.model.make_grid``); nodes[i, j] = i*(ny+1) + j.

    Returns D (nx+1, b, b) diagonal blocks and E (nx, b, b) sub-diagonal
    blocks (E_i = A[line i+1, line i]), b = ndof*(ny+1), in mats' dtype.
    Each element entry is scattered once into its block with
    ``index_put_(..., accumulate=True)``, where JAX scatters three masked
    (nx, b, b) transients and adds them: the sums agree to rounding, and
    no transient is made.
    """
    b = ndof * (ny + 1)
    d4 = 4 * ndof
    # local DOF -> line offset (0/1) and node offset along the line
    line = np.repeat([0, 1, 1, 0], ndof)
    joff = np.repeat([0, 0, 1, 1], ndof)
    comp = np.tile(np.arange(ndof), 4)
    col = ndof * (np.arange(ny)[:, None] + joff[None, :]) + comp[None, :]
    Me = mats.reshape(ny, nx, d4, d4)
    dev = mats.device
    D = mats.new_zeros((nx + 1, b, b))
    E = mats.new_zeros((nx, b, b))
    lines = torch.arange(nx, device=dev)[None, :, None]
    # (row line, column line) -> target: within line i, within line i+1,
    # and A[line i+1, line i]
    for la, lc, out, shift in ((0, 0, D, 0), (1, 1, D, 1), (1, 0, E, 0)):
        a, c = np.nonzero((line[:, None] == la) & (line[None, :] == lc))
        rows = torch.as_tensor(col[:, a], device=dev)[:, None, :]
        cols = torch.as_tensor(col[:, c], device=dev)[:, None, :]
        out.index_put_((lines + shift, rows, cols),
                       Me[:, :, torch.as_tensor(a, device=dev),
                          torch.as_tensor(c, device=dev)],
                       accumulate=True)
    return D, E


def block_tridiag_from_dof_groups(mats, dofs, group_of_dof, nb, b):
    """Element matrices -> block-tridiagonal blocks for any DOF grouping
    where elements couple only adjacent groups (e.g. wingbox stations).

    mats : (nelems, d, d); dofs : (nelems, d) global DOF indices, with the
    DOFs of a group contiguous: dof = group*b + offset. Returns D (nb, b, b)
    and E (nb-1, b, b) with E_i = A[group i+1, group i]. Zero diagonal
    entries (padding, masked DOFs) become 1, added in place, so the
    Cholesky exists. D and E are views of buffers of nb + 1 blocks, whose
    last block takes the scatter's masked entries; no other tensor of
    their size is made.
    """
    del group_of_dof  # implied by the contiguous dof = group*b + off layout
    gi = dofs // b
    wi = dofs % b
    same = gi[:, :, None] == gi[:, None, :]
    lower = gi[:, :, None] == gi[:, None, :] + 1
    rows, cols = wi[:, :, None], wi[:, None, :]
    zero = mats.new_zeros(())

    D = mats.new_zeros((nb + 1, b, b))
    D.index_put_((torch.where(same, gi[:, :, None], nb), rows, cols),
                 torch.where(same, mats, zero), accumulate=True)
    E = mats.new_zeros((nb + 1, b, b))
    E.index_put_((torch.where(lower, gi[:, None, :], nb), rows, cols),
                 torch.where(lower, mats, zero), accumulate=True)
    D, E = D[:nb], E[:nb - 1]
    fix = (torch.diagonal(D, dim1=1, dim2=2) == 0.0).to(mats.dtype)
    torch.diagonal(D, dim1=1, dim2=2).add_(fix)
    return D, E


def _cholesky(S):
    """Lower Cholesky factor(s) of S, NaN where S is not SPD."""
    L, info = torch.linalg.cholesky_ex(S)
    return L.masked_fill_((info != 0)[..., None, None], torch.nan)


def _lower_inverse(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


class BlockTridiagFactor:
    """apply(x) = A^{-1} x for block-tridiagonal SPD A via block Cholesky.

    Stores the inverses of the Cholesky diagonal blocks (Linv) and the
    scaled couplings F_i = E_i Linv_i^T, so an apply is GEMMs only.
    """

    def __init__(self, Linv, F, shape_info):
        self.Linv = Linv  # (nb, b, b)
        self.F = F  # (nb-1, b, b); None for one block
        self.nb, self.b = shape_info

    @classmethod
    def from_blocks(cls, D, E, store_dtype=None):
        """Factorize in the blocks' dtype, and optionally store the factor
        in a narrower one (f32; wrap it with RefinedFactor)."""
        return cls.from_owned_blocks([D, E], store_dtype)

    @classmethod
    def from_owned_blocks(cls, blocks, store_dtype=None):
        """``from_blocks`` of blocks = [D, E], a list this empties: D and
        E are freed before the factor's blocks are stacked, unless the
        caller holds them too."""
        D, E = blocks
        blocks.clear()
        nb, b = D.shape[0], D.shape[1]
        # S_i = D_i - F_{i-1} F_{i-1}^T, L_i = chol(S_i), F_i = E_i L_i^-T
        Linvs, Fs = [], []
        F_prev = torch.zeros_like(D[0])
        for i in range(nb):
            Linv = _lower_inverse(_cholesky(D[i] - F_prev @ F_prev.T))
            Linvs.append(Linv)
            if i < nb - 1:
                F_prev = E[i] @ Linv.T
                Fs.append(F_prev)
        del D, E
        Linv_all = torch.stack(Linvs)
        Linvs.clear()
        F_sub = torch.stack(Fs) if nb > 1 else None
        Fs.clear()
        if store_dtype is not None:
            Linv_all = Linv_all.to(store_dtype)
            F_sub = F_sub.to(store_dtype) if F_sub is not None else None
        return cls(Linv_all, F_sub, (nb, b))

    @property
    def shape(self):
        n = self.nb * self.b
        return (n, n)

    @property
    def dtype(self):
        return self.Linv.dtype

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.to(self.Linv.dtype)  # the sweeps run at the factor's precision
        k = x.shape[1]
        xb = x.reshape(self.nb, self.b, k)
        # forward: y_i = Linv_i (x_i - F_{i-1} y_{i-1})
        Y = []
        for i in range(self.nb):
            r = xb[i] if i == 0 else xb[i] - self.F[i - 1] @ Y[-1]
            Y.append(self.Linv[i] @ r)
        # backward: z_i = Linv_i^T (y_i - F_i^T z_{i+1})
        Z = [None] * self.nb
        for i in reversed(range(self.nb)):
            r = Y[i] if i == self.nb - 1 else Y[i] - self.F[i].T @ Z[i + 1]
            Z[i] = self.Linv[i].T @ r
        out = torch.stack(Z).reshape(self.nb * self.b, k)
        return out[:, 0] if squeeze else out

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)


class BCRFactor:
    """Block cyclic reduction solver for SPD block-tridiagonal systems.

    The same solve as BlockTridiagFactor in log2(nb) levels, each one
    batched Cholesky / GEMM over all odd-indexed blocks at once. With row
    i: E_{i-1} x_{i-1} + D_i x_i + E_i^T x_{i+1} = f_i, one level is
      odd j:  x_j = Dinv_j (f_j - E_{j-1} x_{j-1} - E_j^T x_{j+1})
      even i: D'_i = D_i - E_{i-1} Dinv_{i-1} E_{i-1}^T
                     - E_i^T Dinv_{i+1} E_i
              E'_k = -E_{2k+1} Dinv_{2k+1} E_{2k}
              f'_i = f_i - E_{i-1} Dinv_{i-1} f_{i-1}
                     - E_i^T Dinv_{i+1} f_{i+1}
    Stored per level (odd-indexed, batched): Dinv, HL = Dinv E_{j-1},
    HR = Dinv E_j^T; the even rows' weights are their transposes.

    A factor built with ``coupling`` (the matrix's grid stencil) stores
    level 0 as (Dinv, None, None): there E is the stencil's line-to-line
    taps, so with z = x on the even lines and 0 on the odd ones, the odd
    lines of A z are E_{j-1} x_{j-1} + E_j^T x_{j+1}, and with w = Dinv f
    on the odd lines and 0 on the even ones, the even lines of A w are
    the even rows' sums. Level 0 then costs two stencil calls an apply
    (the span ``eigd.factor.coupling``) in place of four block sets.
    """

    def __init__(self, levels, last_Dinv, nb, b, coupling=None):
        self.levels = tuple(levels)  # ((Dinv, HL, HR), ...) per level
        self.last_Dinv = last_Dinv  # (nb_last, b, b)
        self.nb = nb
        self.b = b
        # GridStencilOperator applying level 0's couplings, or None
        self.coupling = coupling

    @staticmethod
    def _inv_spd(Dblocks, jitter=0.0):
        """Batched SPD inverse through Cholesky: Linv^T Linv, the
        reference's rounding structure (not ``cholesky_inverse``).

        jitter > 0 adds ``jitter * diag(D)`` before the Cholesky (a
        Manteuffel shift): the factor is then only a preconditioner, for
        PCGFactor or RefinedFactor, whose f64 iteration absorbs it."""
        if jitter:
            diag = torch.diagonal(Dblocks, dim1=1, dim2=2)
            Dblocks = Dblocks + torch.diag_embed(jitter * diag)
        Linv = _lower_inverse(_cholesky(Dblocks))
        return Linv.mT @ Linv

    @classmethod
    def from_blocks(cls, D, E, min_blocks=1, store_dtype=None, jitter=0.0):
        """The factor of the blocks D (nb, b, b) and E (nb-1, b, b), which
        the caller keeps (``from_owned_blocks`` takes them over)."""
        return cls.from_owned_blocks([D, E], min_blocks, store_dtype,
                                     jitter)

    @classmethod
    def from_owned_blocks(cls, blocks, min_blocks=1, store_dtype=None,
                          jitter=0.0, coupling=None):
        """The factor of blocks = [D, E], a list this empties. Every level
        runs in one order: Dinv, the evens' clone, HR with its updates of
        D' and E', E cut down to a copy of E_left, HL last. Holding the
        only references, the build frees D once the clone is made and E
        once E_left is copied, so a level holds at most its input and two
        n_odd temporaries (the odd blocks' Cholesky factor and its
        inverse) beside what it keeps. Each product and each update of D'
        is the plain loop's, operand for operand and in its order, so the
        stored blocks are the same bits whoever holds the input.

        ``coupling``, a ``GridStencilOperator`` of the same f64 matrix
        whose grid lines are the blocks, makes level 0 keep Dinv alone and
        apply its couplings through the stencil (class docstring): its HL
        and HR are freed once the next level's blocks are formed. The
        factor keeps the stencil's f64 planes alone
        (``GridStencilOperator.planes_only``)."""
        Dc, Ec = blocks
        blocks.clear()
        nb, b = Dc.shape[0], Dc.shape[1]
        if store_dtype is not None:
            Dc = Dc.to(store_dtype)
            Ec = Ec.to(store_dtype)
        levels = []
        while Dc.shape[0] > max(1, min_blocks):
            n_odd = Dc.shape[0] // 2
            # a coupled factor's level 0 stores Dinv alone
            keep = coupling is None or bool(levels)
            Dinv = cls._inv_spd(Dc[1::2], jitter)
            Dn = Dc[0::2].clone()
            del Dc
            E_right = Ec[1::2]  # E_{2k+1}: the odd lines with a right
            n_r = E_right.shape[0]  # neighbour, n_odd - 1 when nb_c even
            HR = Dinv[:n_r] @ E_right.mT
            # D' on the evens: minus HR_{k-1}^T E_right_{k-1}^T (k >= 1)
            Dn[1:1 + n_r] -= HR.mT @ E_right.mT
            # E' couples even k -> k+1 while odd 2k+1 and even 2k+2 exist
            En = (HR.mT @ Ec[0::2][:n_r]).neg_()
            del E_right
            if not keep:
                del HR
            E_left = Ec[0::2][:n_odd].clone()  # E_{2k}
            del Ec
            HL = Dinv @ E_left
            # and minus HL_k^T E_left_k (k < n_odd)
            Dn[:n_odd] -= HL.mT @ E_left
            del E_left
            if keep:
                if n_r < n_odd:  # the last odd line's HR is zero
                    HR = torch.cat([HR, HR.new_zeros((n_odd - n_r, b, b))])
                levels.append((Dinv, HL, HR))
                del HR
            else:
                levels.append((Dinv, None, None))
            del HL
            Dc, Ec = Dn, En
        if coupling is not None and levels:
            coupling = coupling.planes_only()
        else:
            coupling = None
        return cls(levels, cls._inv_spd(Dc, jitter), nb, b, coupling)

    @property
    def shape(self):
        n = self.nb * self.b
        return (n, n)

    @property
    def dtype(self):
        return self.last_Dinv.dtype

    @property
    def nbytes(self):
        """Bytes the stored factor holds, the coupling's planes included."""
        blocks = [t for lv in self.levels for t in lv if t is not None]
        held = sum(t.numel() * t.element_size()
                   for t in blocks + [self.last_Dinv])
        return held + (0 if self.coupling is None else self.coupling.nbytes)

    def _solve_coupled(self, f):
        """Level 0 through the stencil: g = Dinv f_odd; the evens' right-
        hand sides less the even lines of A w (w: g on the odd lines);
        x_odd = g - Dinv (A z)_odd (z: x_even on the even lines). The two
        stencil calls are the span ``eigd.factor.coupling``, whose work
        counts the apply's columns once."""
        Dinv = self.levels[0][0]
        nb, b, k = f.shape
        g = Dinv @ f[1::2]
        w = f.new_zeros((nb, b, k))
        w[1::2] = g
        with span("eigd.factor.coupling", k):
            Aw = _StencilApply.apply(w.reshape(nb * b, k), self.coupling)
        del w
        x_even = self._solve(1, f[0::2] - Aw.reshape(nb, b, k)[0::2])
        del Aw
        x = f.new_zeros((nb, b, k))
        x[0::2] = x_even
        with span("eigd.factor.coupling"):
            Az = _StencilApply.apply(x.reshape(nb * b, k), self.coupling)
        x[1::2] = g - Dinv @ Az.reshape(nb, b, k)[1::2]
        return x

    def _solve(self, idx, f):
        """f: (nb_level, b, k) right-hand sides at this level."""
        if idx == len(self.levels):
            return self.last_Dinv @ f
        if idx == 0 and self.coupling is not None:
            return self._solve_coupled(f)
        Dinv, HL, HR = self.levels[idx]
        n_odd = Dinv.shape[0]
        f_odd = f[1::2]
        f_even = f[0::2].clone()
        n_even = f_even.shape[0]

        # f_even' = f_even - HR_{k-1}^T f_odd[k-1] - HL_k^T f_odd[k]
        n_l = min(n_odd, n_even - 1)
        f_even[1:1 + n_l] -= (HR.mT @ f_odd)[:n_l]
        f_even[:n_odd] -= HL.mT @ f_odd

        x_even = self._solve(idx + 1, f_even)

        # x_odd = Dinv f_odd - HL x_even[k] - HR x_even[k+1]
        x_odd = Dinv @ f_odd - HL @ x_even[:n_odd]
        n_r = min(n_odd, n_even - 1)
        x_odd[:n_r] -= HR[:n_r] @ x_even[1:1 + n_r]

        x = x_even.new_empty((n_even + n_odd,) + x_even.shape[1:])
        x[0::2] = x_even
        x[1::2] = x_odd
        return x

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.to(self.dtype)
        k = x.shape[1]
        out = self._solve(0, x.reshape(self.nb, self.b, k))
        out = out.reshape(self.nb * self.b, k)
        return out[:, 0] if squeeze else out

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)


class _StencilApply(torch.autograd.Function):
    """y = A v through a fixed operator's ``mv`` (a factor's coupling
    stencil, K2 on the card) as autograd and torch.func see it. A is
    linear and symmetric, so its tangent map and its adjoint are A again,
    applied through this same function: ``mv`` runs on untracked tensors
    under any nesting of transforms (the static solve's forward-mode rule
    applies the factor to a tangent)."""

    @staticmethod
    def forward(v, op):
        return op.mv(v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def backward(ctx, y_bar):
        return _StencilApply.apply(y_bar, ctx.op), None

    @staticmethod
    def jvp(ctx, dv, _):
        return _StencilApply.apply(dv, ctx.op)


class RefinedFactor:
    """Mixed-precision exact solve: an f32 factor with f64 iterative
    refinement against the matrix-free operator,
        y_{k+1} = y_k + M32^{-1} (x - A y_k),
    until the f64 residual of every column is under ``tol`` relative, at
    ``max_refine`` passes, or once refinement stagnates (after two passes,
    a pass that does not cut the total squared residual by 4x: it bottoms
    out at about eps64 * cond(A)). Each pass reads its exit decision on
    the host (``sync.HOST_SYNCS["refine"]``; exits in ``LOOP_EXITS``).
    """

    def __init__(self, inner, op, tol=1e-13, max_refine=20):
        self.inner = inner  # f32 factor (BCRFactor, BlockTridiagFactor)
        self.op = op  # f64 operator for A
        self.tol = tol
        self.max_refine = max_refine

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return torch.float64

    def _approx(self, r):
        return self.inner.mv(r.to(torch.float32)).to(torch.float64)

    @span("eigd.factor.apply", work=columns)
    def approx_mv(self, r):
        """One preconditioner-quality solve (the bare f32 inner apply, in
        the inner factor's dtype), for mixed-precision Krylov ladders."""
        return self.inner.mv(r)

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.to(torch.float64)
        nrm2 = torch.sum(x * x, dim=0)
        tol2 = (self.tol ** 2) * torch.clamp(nrm2, min=1e-300)
        y = self._approx(x)
        r2 = torch.full_like(nrm2, torch.inf)
        r2_prev = r2
        k = 0
        while k < self.max_refine:
            # before the first pass the residual is unknown: JAX's
            # condition is true there without reading it
            if k > 0:
                unconverged, improving = host_flags(torch.stack([
                    torch.any(r2 > tol2),
                    torch.sum(r2) < 0.25 * torch.sum(r2_prev)]), "refine")
                if not unconverged:
                    why = "converged"
                    break
                if k >= 2 and not improving:
                    why = "stagnated"
                    break
            r = x - self.op.mv(y)
            y = y + self._approx(r)
            r2_prev, r2 = r2, torch.sum(r * r, dim=0)
            k += 1
        else:
            why = "maxiter"
        loop_exit("refine", why, k)
        return y[:, 0] if squeeze else y

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)


def blocked_pcg(y, r, opmv, pre, tol2, maxiter, site, sums=None):
    """Blocked PCG from the iterate y and its residual r, (n, k) blocks,
    with per-column alpha and beta: a column under ``tol2`` freezes, and
    the loop ends when all are or at ``maxiter``, one host decision an
    iteration (``host_flags`` at ``site``). ``sums`` as in
    ``multigrid.flexible_pcg``. Returns (y, per-column r2, iterations).
    """
    if sums is None:
        def sums(*pairs):
            return [torch.sum(a * b, dim=0) for a, b in pairs]

    z = pre(r)
    rz, r2 = sums((r, z), (r, r))
    p = z
    k = 0
    while k < maxiter:
        if not host_flags(torch.any(r2 > tol2)[None], site)[0]:
            why = "converged"
            break
        active = r2 > tol2
        Ap = opmv(p)
        pAp, = sums((p, Ap))
        alpha = torch.where(active, rz / torch.where(pAp == 0.0, 1.0, pAp),
                            0.0)
        y = y + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = pre(r)
        rzn, r2 = sums((r, z), (r, r))
        beta = torch.where(active, rzn / torch.where(rz == 0.0, 1.0, rz),
                           0.0)
        p = z + beta[None, :] * p
        rz = rzn
        k += 1
    else:
        why = "maxiter"
    loop_exit(site, why, k)
    return y, r2, k


class PCGFactor:
    """Robust mixed-precision solve for ill-conditioned (thin-shell)
    systems: f64 PCG preconditioned by an f32 factor of the equilibrated
    matrix S A S, S = diag(s).

    inner : f32 factor of S A S (e.g. a jittered BCRFactor).
    op    : f64 operator for A.
    s     : (n,) f64 equilibration scale.
    mask  : (n,) 1.0 free, 0.0 constrained or padded; the operator's zero
        rows there are completed with the identity, as the unit diagonals
        of the preconditioner's blocks are, so the system stays SPD.

    Every solve is ``blocked_pcg`` on the blocked right-hand sides.
    """

    def __init__(self, inner, op, s, mask=None, tol=1e-12, maxiter=200,
                 approx_tol=1e-5, approx_maxiter=30):
        self.inner = inner
        self.op = op
        self.s = s
        self.mask = mask
        self.tol = tol
        self.maxiter = maxiter
        self.approx_tol = approx_tol
        self.approx_maxiter = approx_maxiter
        self._op32 = None  # the f32 element operator of the approx channel

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return torch.float64

    def _pre(self, r):
        """One preconditioner apply: S M32^{-1} S r (f64 in and out)."""
        s = self.s[:, None]
        return s * self.inner.mv((s * r).to(torch.float32)).to(torch.float64)

    @span("eigd.factor.apply", work=columns)
    def approx_mv(self, r):
        """Inexact solve for mixed ladders and approximate sweeps: the same
        PCG truncated at (approx_tol, approx_maxiter), in f32 with an f32
        element matvec when the operator has element matrices."""
        if getattr(self.op, "mats", None) is not None:
            return self._pcg32(r, self.approx_tol, self.approx_maxiter)
        return self._pcg(r, self.approx_tol, self.approx_maxiter)[0]

    def _pcg32(self, x, tol, maxiter):
        """The approximate channel's PCG with f32 state, an f32 element
        matvec and the f32 preconditioner."""
        f32 = torch.float32
        if self._op32 is None:
            # cast once a factor: every approx apply reads the same copy
            self._op32 = ElementOperator(self.op.mats.to(f32), self.op.dofs,
                                         self.op.n)
        op32 = self._op32
        s32 = self.s.to(f32)[:, None]
        mask32 = None if self.mask is None else self.mask.to(f32)

        def opmv(p):
            y = op32.mv(p)
            if mask32 is not None:
                y = y + (1.0 - mask32)[:, None] * p
            return y

        def pre(r):
            return s32 * self.inner.mv(s32 * r)

        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.to(f32)
        nrm2 = torch.sum(x * x, dim=0)
        tol2 = (tol * tol) * torch.clamp(nrm2, min=1e-30)
        y, _, _ = blocked_pcg(torch.zeros_like(x), x, opmv, pre, tol2,
                              maxiter, "pcg_factor_f32")
        return y[:, 0] if squeeze else y

    def _opmv(self, p):
        y = self.op.mv(p)
        if self.mask is not None:
            y = y + (1.0 - self.mask)[:, None] * p
        return y

    @span("eigd.factor.apply", work=columns)
    def precond_mv(self, r):
        """ONE raw preconditioner apply (the mixed SIBK "precond" ladder)."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        y = self._pre(r.to(torch.float64))
        return y[:, 0] if squeeze else y

    @span("eigd.factor.apply", work=columns)
    def mv_info(self, x):
        return self._pcg(x, self.tol, self.maxiter)

    @span("eigd.factor.apply", work=columns)
    def mv_warm(self, x, x0):
        """Accurate solve warm-started at x0; the gate stays relative to
        ||x||, so the guess only removes iterations."""
        return self._pcg(x, self.tol, self.maxiter, x0=x0)[0]

    def _pcg(self, x, tol, maxiter, x0=None):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
            x0 = None if x0 is None else x0[:, None]
        x = x.to(torch.float64)
        nrm2 = torch.sum(x * x, dim=0)
        tol2 = (tol ** 2) * torch.clamp(nrm2, min=1e-300)
        if x0 is None:
            y, r = torch.zeros_like(x), x
        else:
            y = x0.to(torch.float64)
            r = x - self._opmv(y)
        y, r2, k = blocked_pcg(y, r, self._opmv, self._pre, tol2, maxiter,
                               "pcg_factor")
        info = {"niter": k,
                "res": torch.sqrt(r2 / torch.clamp(nrm2, min=1e-300))}
        return (y[:, 0] if squeeze else y), info

    @span("eigd.factor.apply", work=columns)
    def mv(self, x):
        return self.mv_info(x)[0]

    @span("eigd.factor.apply", work=columns)
    def __call__(self, x):
        return self.mv(x)
