"""Shift-and-invert Lanczos with B-inner-product orthogonalization.

Counterpart of ``eigd_tpu/ops/lanczos.py``: the single-vector solver
(``lanczos_iteration``, ``lanczos_solve``) and the block path
(``block_lanczos_solve`` and its setup, extraction and Ritz polish). The
reduced symmetric eigenproblems use ``torch.linalg.eigh`` in f64, which
takes the place of JAX's ``eigh_accurate`` (a Jacobi polish that exists
because XLA:TPU's eigh floors near 1e-7). The basis arrays are
preallocated and updated in place. ``BasicLanczos`` is the host wrapper
with the reference's class surface: the Ntarget mode count, the
convergence warnings and the adjoint dispatch.
"""

from __future__ import annotations

import dataclasses
import types
import warnings

import torch

from .collective import chunked_dot_f32, pdot, psum
from .operators import as_operator
from .sync import host_bool, loop_exit


def map_ritz_values(theta, sigma, mode):
    """Undo the spectral map, and the order of the wanted modes first:

        normal:   lam = 1/theta + sigma,              by lam
        buckling: lam = sigma theta/(theta-1),        by -1/lam
        cayley:   lam = sigma (theta+1)/(theta-1),    by lam
                  (theta = 1 maps to +inf)
    """
    if mode == "normal":
        lam = 1.0 / theta + sigma
        return lam, torch.argsort(lam, stable=True)
    if mode == "buckling":
        lam = sigma * theta / (theta - 1.0)
        return lam, torch.argsort(-1.0 / lam, stable=True)
    if mode == "cayley":
        denom = theta - 1.0
        lam = torch.where(denom == 0.0, torch.inf, sigma * (theta + 1.0)
                          / torch.where(denom == 0.0, 1.0, denom))
        return lam, torch.argsort(lam, stable=True)
    raise ValueError(f"Unknown mode {mode!r}")


def _tridiagonal(alpha, beta):
    """The (m, m) tridiagonal T of the Lanczos coefficients; beta[m-1] is
    the last residual norm and does not enter T."""
    T = torch.diag(alpha)
    if alpha.shape[0] > 1:
        off = torch.diag(beta[:-1], 1)
        T = T + off + off.T
    return T


def solve_reduced_problem(alpha, beta, sigma, mode):
    """Eigendecomposition of T plus the eigenvalue map and sort order."""
    theta, Y = torch.linalg.eigh(_tridiagonal(alpha, beta))
    lam, order = map_ritz_values(theta, sigma, mode)
    return theta, Y, lam, order


def full_rayleigh_ritz(BV, W_raw, sigma, mode):
    """Rayleigh-Ritz with the fully measured projected operator
    ``Hf[j, i] = BV[j] . W_raw[i]``, symmetrized."""
    Hf = BV @ W_raw.T
    T = 0.5 * (Hf + Hf.T)
    theta, Y = torch.linalg.eigh(T)
    lam, order = map_ritz_values(theta, sigma, mode)
    return theta, Y, lam, order


@dataclasses.dataclass
class LanczosResult:
    """Everything the adjoint solvers need from the forward eigensolve."""

    lam: torch.Tensor  # (N,) selected eigenvalues, sorted
    Phi: torch.Tensor  # (n, N) B-orthonormal eigenvectors
    V: torch.Tensor  # (m+1, n) Lanczos basis (rows)
    BV: torch.Tensor  # (m+1, n) cached B @ V (dropped after the forward)
    alpha: torch.Tensor  # (m,)
    beta: torch.Tensor  # (m,)
    H: torch.Tensor  # (m, m) symmetrized projected operator
    theta: torch.Tensor  # (m,) reduced eigenvalues (eigh order)
    Y: torch.Tensor  # (m, m) reduced eigenvectors (eigh order)
    order: torch.Tensor  # (m,) sort order of mapped eigenvalues
    lam_all: torch.Tensor  # (m,) all mapped Ritz values (eigh order)
    eig_res: torch.Tensor  # (N,) per-mode residual estimate
    sigma: torch.Tensor  # scalar shift
    niter: int  # Krylov vectors actually built
    eig_res_measured: torch.Tensor = None  # (N,) measured pencil residual
    deflated: bool = False  # the chain was kept B-orthogonal to known rows

    @property
    def m(self):
        return self.alpha.shape[0]

    @property
    def N(self):
        return self.lam.shape[0]

    @property
    def Ys(self):
        """Reduced eigenvectors permuted to sorted-eigenvalue order."""
        return self.Y[:, self.order]

    @property
    def theta_s(self):
        return self.theta[self.order]


def b_orthonormalize_rows(U0, B_mv, axis=None):
    """B-orthonormalize a small set of row vectors (modified Gram-Schmidt).

    U0 : (k, n) rows, DOF-sharded over ``axis``. Returns (U, BU) with U
    B-orthonormal.
    """
    rows, brows = [], []
    for i in range(U0.shape[0]):
        u = U0[i]
        for v, bv in zip(rows, brows):
            u = u - pdot(bv, u, axis) * v
        bu = B_mv(u)
        nrm = torch.sqrt(pdot(u, bu, axis))
        rows.append(u / nrm)
        brows.append(bu / nrm)
    return torch.stack(rows), torch.stack(brows)


def b_qr_tall(X, B_mv, axis=None):
    """B-orthonormal thin QR of an (n, p) block, DOF-sharded over
    ``axis``, by column-scaled CholeskyQR2 in the B inner product (the Gram
    matrix all-reduced). Returns (Q, BQ, R) with Q^T B Q = I and X = Q R.

    The (n, p) block is solved against L^T from the right as it lies: the
    left-sided solve of JAX on its (p, n) transpose is the same triangular
    solve, but torch's CUDA one takes 5-9 s at n = 1,051,650, p = 8 on an
    H100, contiguous or not, where the right-sided one takes 0.2-0.4 ms
    (``python -m eigd_tpu_torch.diag.profile triangular``)."""
    def solve_cols(L, Z):
        return torch.linalg.solve_triangular(L.T, Z, upper=True, left=False)

    def one_pass(X, BX):
        G = psum(X.T @ BX, axis)
        G = 0.5 * (G + G.T)
        cn = torch.sqrt(torch.clamp(torch.diagonal(G), min=1e-300))
        Gs = G / (cn[:, None] * cn[None, :])
        eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        L = torch.linalg.cholesky(Gs + 1e-14 * eye)
        Q = solve_cols(L, X / cn[None, :])
        BQ = solve_cols(L, BX / cn[None, :])
        return Q, BQ, L.T * cn[None, :]

    Q, BQ, R1 = one_pass(X, B_mv(X))
    Q, BQ, R2 = one_pass(Q, BQ)
    return Q, BQ, R2 @ R1


def _deflator(deflate, axis=None):
    """Projector keeping a block B-orthogonal to the deflated rows (U, BU)
    (identity without deflation)."""
    if deflate is None:
        return lambda Wb: Wb
    U, BU = deflate
    return lambda Wb: Wb - U.T @ psum(BU @ Wb, axis)


def polish_ritz_block(A, B, factor, lam, Phi, sigma, mode, deflate=None,
                      axis=None, nsteps=1):
    """Shift-invert subspace-iteration polish of the selected Ritz block,
    with a pencil Rayleigh-Ritz re-extraction.

    Each step applies the accurate factor to B Phi (warm-started at
    Phi/(lam - sigma), or Phi lam/(lam - sigma) in buckling mode, when the
    factor has ``mv_warm``), B-orthonormalizes, and re-extracts from the
    pencil projected on that block: A phi = mu B phi, with lam = mu, or
    the load factor lam = -1/mu in buckling mode, (A, B) = (G, K). Returns
    (lam, Phi, eig_res) with eig_res the measured pencil residual
    ||A phi - mu B phi|| of the returned pairs.
    """
    defl = _deflator(deflate, axis)

    mv_warm = getattr(factor, "mv_warm", None)
    for _ in range(nsteps):
        if mv_warm is not None:
            denom = lam - sigma
            zero = denom == 0.0
            safe = torch.where(zero, 1.0, denom)
            scale = torch.where(zero, 0.0, (lam / safe) if mode == "buckling"
                                else 1.0 / safe)
            Z = mv_warm(B.mv(Phi), Phi * scale[None, :])
        else:
            Z = factor.mv(B.mv(Phi))
        Z, BZ, _ = b_qr_tall(defl(Z), B.mv, axis)
        AZ = A.mv(Z)
        Hp = psum(Z.T @ AZ, axis)  # (N, N); Z^T B Z = I
        Hp = 0.5 * (Hp + Hp.T)
        mu, Wp = torch.linalg.eigh(Hp)
        order = torch.argsort(mu, stable=True)
        if mode == "buckling":
            zero = mu == 0.0
            lam = torch.where(zero, torch.inf,
                              -1.0 / torch.where(zero, 1.0, mu))[order]
        else:
            lam = mu[order]
        Wsel = Wp[:, order]
        mu_sel = mu[order]
        Phi = Z @ Wsel
    R = AZ @ Wsel - (BZ @ Wsel) * mu_sel[None, :]
    eig_res = torch.sqrt(psum(torch.sum(R * R, dim=0), axis))
    return lam, Phi, eig_res


def _uniform_block(n, p, seed, dtype, device):
    g = torch.Generator().manual_seed(seed)
    v = 2.0 * torch.rand((n, p), generator=g, dtype=torch.float64) - 1.0
    return v.to(device=device, dtype=dtype)


def _block_lanczos_setup(A, B, factor, sigma, N, m, p, mode="normal",
                         seed=12345, v0=None, deflate=None, axis=None,
                         ortho="full", sweep="exact"):
    """Block-Lanczos machinery: the per-step function and the initial
    state. ``step(t, s)`` advances block t of the state ``s`` in place."""
    del mode  # the same recurrence in every mode
    dtype = A.dtype
    n = A.shape[0]
    device = A.device
    if sweep == "approx":
        # the factor's inexact f32 solve (its forward-sweep channel when it
        # has one); the polish's accurate applies recover the eigenpairs.
        # A factor with neither (an f64 BCRFactor) applies exactly, as in JAX
        approx_fn = (getattr(factor, "sweep_mv", None)
                     or getattr(factor, "approx_mv", None) or factor.mv)

        def apply_fn(Xb):
            return approx_fn(Xb).to(dtype)
    elif sweep == "exact":
        def apply_fn(Xb):
            return factor.mv(Xb)
    else:
        raise ValueError(f"Unknown sweep {sweep!r}")
    q = -(-m // p)
    mtot = q * p

    # Start block from explicit torch.Generators (JAX draws from
    # jax.random, which gives other numbers: parity runs pass v0).
    if v0 is None:
        v0 = _uniform_block(n, p, seed, dtype, device)
    if v0.ndim == 1:
        extra = _uniform_block(n, p - 1, seed + 1, dtype, device)
        v0 = torch.cat([v0[:, None], extra], dim=1)

    defl = _deflator(deflate, axis)

    rows = (q + 1) * p
    Q0, BQ0, _ = b_qr_tall(defl(v0), B.mv, axis)
    s = types.SimpleNamespace()
    s.V = torch.zeros((rows, n), dtype=dtype, device=device)
    s.BV = torch.zeros((rows, n), dtype=dtype, device=device)
    s.V[:p] = Q0.T
    s.BV[:p] = BQ0.T
    # Measured projected operator, accumulated by column block (rows above
    # the current block are zero and are recovered by symmetry at the end)
    s.Hraw = torch.zeros((rows, mtot), dtype=dtype, device=device)
    s.Hc = torch.zeros((rows, mtot), dtype=dtype, device=device)
    col = torch.arange(rows, device=device)

    local = ortho == "local" and dtype == torch.float64
    if local:
        s.V32 = s.V.to(torch.float32)
        s.BV32 = s.BV.to(torch.float32)
        s.Graw = torch.zeros((rows, mtot), dtype=dtype, device=device)
    else:
        s.V32 = s.BV32 = s.Graw = None

    def step(t, s):
        lo = t * p
        w = apply_fn(s.BV[lo:lo + p].T)  # (n, p) blocked apply
        if local:
            # merged measurement: [RR column | Gram column] of block t
            hg = psum(s.BV @ torch.cat([w, s.V[lo:lo + p].T], dim=1), axis)
            s.Hraw[:, lo:lo + p] = hg[:, :p]
            s.Graw[:, lo:lo + p] = hg[:, p:]
        else:
            s.Hraw[:, lo:lo + p] = psum(s.BV @ w, axis)
        w = defl(w)
        if local:
            # three-term recurrence against the previous two blocks, plus
            # one f32 sweep against the whole basis (bounds the Paige
            # drift; the Gram Rayleigh-Ritz absorbs what is left)
            lo2 = max(lo - p, 0)
            Vp = s.V[lo2:lo2 + 2 * p]
            BVp = s.BV[lo2:lo2 + 2 * p]
            h1l = psum(BVp @ w, axis)
            w = w - Vp.T @ h1l
            h2l = psum(BVp @ w, axis)
            w = w - Vp.T @ h2l
            h = torch.zeros((rows, p), dtype=dtype, device=device)
            h[lo2:lo2 + 2 * p] = h1l + h2l
            mask64 = (col < lo + p).to(dtype)
            hfar = chunked_dot_f32(s.BV32, w, axis) * mask64[:, None]
            w = w - (s.V32.T @ hfar.to(torch.float32)).to(dtype)
            hfar2 = chunked_dot_f32(s.BV32, w, axis) * mask64[:, None]
            w = w - (s.V32.T @ hfar2.to(torch.float32)).to(dtype)
        else:
            mask = (col < lo + p).to(dtype)
            h1 = psum(s.BV @ w, axis) * mask[:, None]
            w = w - s.V.T @ h1
            h2 = psum(s.BV @ w, axis) * mask[:, None]
            w = w - s.V.T @ h2
            h = h1 + h2
        w = defl(w)
        Qb, BQb, Rb = b_qr_tall(w, B.mv, axis)
        s.V[lo + p:lo + 2 * p] = Qb.T
        s.BV[lo + p:lo + 2 * p] = BQb.T
        if local:
            s.V32[lo + p:lo + 2 * p] = Qb.T.to(torch.float32)
            s.BV32[lo + p:lo + 2 * p] = BQb.T.to(torch.float32)
        h[lo + p:lo + 2 * p] = Rb
        s.Hc[:, lo:lo + p] = h

    return types.SimpleNamespace(step=step, state=s, q=q, mtot=mtot)


def _block_lanczos_extract(A, B, factor, sigma, N, mode, s, niter, p,
                           guard_tiny0, ortho, polish, polish_spare,
                           deflate, measure=False, axis=None):
    """Rayleigh-Ritz extraction tail of the block Lanczos solve (symmetric
    completion, Gram Rayleigh-Ritz, selection, residual bound, polish or,
    with ``measure``, the measured pencil residual)."""
    V = s.V
    mtot = s.Hraw.shape[1]
    dtype = V.dtype
    device = V.device
    guard_tiny = guard_tiny0
    blk = torch.arange(mtot, device=device) // p
    filled = blk[:, None] <= blk[None, :]
    Hr = s.Hraw[:mtot]
    Hm = torch.where(filled, Hr, Hr.T)
    H = 0.5 * (Hm + Hm.T)

    if ortho == "local":
        # Generalized Rayleigh-Ritz with the measured Gram matrix, rank
        # revealing: Gram directions below 1e-6 of the largest are dropped
        Gr = s.Graw[:mtot]
        Gm = torch.where(filled, Gr, Gr.T)
        G = 0.5 * (Gm + Gm.T)
        dg = torch.diagonal(G)
        G = G + torch.diag((dg == 0.0).to(dtype))  # inactive rows
        sG, UG = torch.linalg.eigh(G)
        keep = sG > 1e-6 * torch.max(sG)
        inv_sqrt = torch.where(
            keep, 1.0 / torch.sqrt(torch.clamp(sG, min=1e-300)), 0.0)
        Wt = UG * inv_sqrt[None, :]
        Ht = Wt.T @ H @ Wt
        Ht = 0.5 * (Ht + Ht.T)
        theta, Yt = torch.linalg.eigh(Ht)
        Y = Wt @ Yt
        guard_tiny = True  # dropped directions carry theta = 0
    else:
        theta, Y = torch.linalg.eigh(H)
    if guard_tiny:
        # inactive / truncated directions (theta ~ 0) sort last
        scale = torch.max(torch.abs(theta))
        tiny = torch.abs(theta) <= 1e-12 * scale
        safe = torch.where(tiny, 1.0, theta)
        if mode == "buckling":
            lam_all = torch.where(tiny, torch.inf,
                                  sigma * safe / (safe - 1.0))
            order = torch.argsort(torch.where(tiny, 0.0, -1.0 / lam_all),
                                  stable=True)
        else:
            lam_all = torch.where(tiny, torch.inf, 1.0 / safe + sigma)
            order = torch.argsort(lam_all, stable=True)
    else:
        lam_all, order = map_ritz_values(theta, sigma, mode)

    sel = order[:N]
    lam = lam_all[sel]
    Y0 = Y[:, sel]
    Phi = V[:mtot].T @ Y0
    # classical block-Lanczos bound ||R_end Y_last|| of the last block
    lo_end = min(max(niter - p, 0), mtot - p)
    Rblk = s.Hc[lo_end + p:lo_end + 2 * p, lo_end:lo_end + p]
    Ylast = Y0[lo_end:lo_end + p]
    eig_res = torch.sqrt(torch.sum((Rblk @ Ylast) ** 2, dim=0))

    eig_res_measured = None
    if polish:
        spare = min(int(polish_spare), mtot - N) if polish_spare else 0
        if spare > 0:
            # polish an extended Ritz block so errors in the nearby
            # directions just above lam_N contract too
            sel_e = order[:N + spare]
            lam_e = lam_all[sel_e]
            Phi_e = V[:mtot].T @ Y[:, sel_e]
            lam_e, Phi_e, res_e = polish_ritz_block(
                A, B, factor, lam_e, Phi_e, sigma, mode, deflate=deflate,
                axis=axis, nsteps=polish)
            lam, Phi, eig_res = lam_e[:N], Phi_e[:, :N], res_e[:N]
        else:
            lam, Phi, eig_res = polish_ritz_block(
                A, B, factor, lam, Phi, sigma, mode, deflate=deflate,
                axis=axis, nsteps=polish)
        eig_res_measured = eig_res
    elif measure:
        # the true pencil residual ||A phi - mu B phi|| of the returned
        # pairs (mu = -1/lam in buckling mode): under ortho="local" and the
        # approx sweep the coupling bound can understate it by orders
        if mode == "buckling":
            zero = lam == 0.0
            mu = torch.where(zero, 0.0, -1.0 / torch.where(zero, 1.0, lam))
        else:
            mu = lam
        R = A.mv(Phi) - B.mv(Phi) * mu[None, :]
        eig_res_measured = torch.sqrt(psum(torch.sum(R * R, dim=0), axis))

    zeros_m = torch.zeros(mtot, dtype=dtype, device=device)
    return LanczosResult(
        lam=lam, Phi=Phi, V=V, BV=s.BV, alpha=zeros_m, beta=zeros_m, H=H,
        theta=theta, Y=Y, order=order, lam_all=lam_all, eig_res=eig_res,
        sigma=torch.tensor(sigma, dtype=dtype, device=device), niter=niter,
        eig_res_measured=eig_res_measured, deflated=deflate is not None)


def block_lanczos_solve(A, B, factor, sigma, N, m, p, mode="normal",
                        seed=12345, v0=None, deflate=None, axis=None,
                        tol=None,
                        check_every=1, ortho="full", polish=0,
                        polish_spare=0, sweep="exact",
                        measure_res=False) -> LanczosResult:
    """Block shift-invert Lanczos: p Krylov vectors advance per factor
    apply. ``ortho="local"`` orthogonalizes each new block against the
    previous two only and extracts with a generalized Rayleigh-Ritz on the
    measured Gram matrix; ``sweep="approx"`` drives the sweep with the
    factor's inexact f32 solve and relies on ``polish`` accurate applies.
    m is rounded up to a multiple of p. With ``tol`` set the sweep exits
    once the N wanted pairs pass the block coupling bound (one host
    decision per check; ``sync.LOOP_EXITS`` counts which way it ended).
    The exit picks the wanted pairs as the largest theta, which holds for
    the normal map only: outside the normal mode the sweep runs all
    blocks, as in JAX. ``measure_res`` (without polish) measures the true
    pencil residual of the returned pairs into ``eig_res_measured``, two
    thin operator applies that change nothing else. With ``axis`` the DOF
    dimension is sharded over its ranks: every basis product is
    all-reduced, and the exit reads the replicated coupling matrix only.
    """
    A, B = as_operator(A), as_operator(B)
    st = _block_lanczos_setup(A, B, factor, sigma, N, m, p, mode=mode,
                              seed=seed, v0=v0, deflate=deflate, axis=axis,
                              ortho=ortho, sweep=sweep)
    step, q, mtot, s = st.step, st.q, st.mtot, st.state
    if tol is None or mode != "normal":
        for t in range(q):
            step(t, s)
        niter = mtot
    else:
        row = torch.arange(mtot, device=s.V.device)
        min_blocks = -(-N // p) + 1

        def converged(t1):
            active = (row < t1 * p).to(s.Hc.dtype)
            Hm = s.Hc[:mtot] * active[:, None] * active[None, :]
            Hm = 0.5 * (Hm + Hm.T)
            theta, Y = torch.linalg.eigh(Hm)
            sel = torch.argsort(-theta, stable=True)[:N]
            lo = (t1 - 1) * p
            Rblk = s.Hc[lo + p:lo + 2 * p, lo:lo + p]
            Ylast = Y[lo:lo + p][:, sel]
            res = torch.sqrt(torch.sum((Rblk @ Ylast) ** 2, dim=0))
            scale = torch.clamp(torch.max(torch.abs(theta)), min=1.0)
            return host_bool(torch.all(res < tol * scale), "lanczos_exit")

        t = 0
        while t < q:
            step(t, s)
            t += 1
            if t % check_every == 0 and t >= min_blocks and converged(t):
                loop_exit("lanczos_exit", "converged", t)
                break
        else:
            loop_exit("lanczos_exit", "last_block", t)
        niter = t * p
    return _block_lanczos_extract(
        A, B, factor, sigma, N, mode, s, niter, p, tol is not None, ortho,
        polish, polish_spare, deflate, measure=measure_res, axis=axis)


# ---------------------------------------------------------------------------
# Single-vector solver
# ---------------------------------------------------------------------------


def lanczos_iteration(factor_mv, B_mv, v0, m, deflate=None, axis=None,
                      tol=None, nwanted=None, check_every=8, min_iter=None,
                      apply_op=None):
    """Up to m shift-invert Lanczos steps on ``factor(B v)`` with full
    B-orthogonalization (CGS2 against the cached B V rows).
    ``apply_op(v, Bv)``, if given, is the iterated operator instead (the
    Cayley map's ``factor(A v + sigma B v)``).

    v0 : (n,) start vector (normalized here). deflate : optional (U, BU)
    rows kept out of the Krylov space. With ``tol`` set, every
    ``check_every`` steps (from ``min_iter``, default nwanted + 2) the
    reduced tridiagonal problem is solved and the loop exits once the
    ``nwanted`` largest-theta pairs satisfy
    ``|beta_i Y[i-1, j]| < tol * max(|theta|, 1)``: one host decision per
    check, counted in ``sync.HOST_SYNCS["lanczos1_exit"]``. A breakdown
    (||w||_B^2 <= 1e-60) freezes the recurrence with zero rows. With
    ``axis`` the vectors are DOF-sharded and every inner product is
    all-reduced, so alpha, beta and each exit decision are replicated.

    Returns (V, BV, alpha, beta, W_raw, niter): the (m+1, n) basis and its
    B products (rows from niter on are zero), the coefficients, the (m, n)
    raw operator outputs for the full Rayleigh-Ritz, and the steps run.
    """
    n = v0.shape[0]
    dtype = v0.dtype
    device = v0.device
    defl = _deflator(deflate, axis)

    v0 = defl(v0)
    bv0 = B_mv(v0)
    b0 = torch.sqrt(pdot(v0, bv0, axis))
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    BV = torch.zeros((m + 1, n), dtype=dtype, device=device)
    V[0] = v0 / b0
    BV[0] = bv0 / b0
    alpha = torch.zeros(m, dtype=dtype, device=device)
    beta = torch.zeros(m, dtype=dtype, device=device)
    W_raw = torch.zeros((m, n), dtype=dtype, device=device)
    col = torch.arange(m + 1, device=device)

    def step(i):
        w = factor_mv(BV[i]) if apply_op is None else apply_op(V[i], BV[i])
        W_raw[i] = w
        mask = (col <= i).to(dtype)
        w = defl(w)
        h1 = pdot(BV, w, axis) * mask
        w = w - V.T @ h1
        h2 = pdot(BV, w, axis) * mask
        w = w - V.T @ h2
        w = defl(w)
        h = h1 + h2
        bw = B_mv(w)
        b2 = pdot(w, bw, axis)
        ok = b2 > 1e-60
        b = torch.sqrt(torch.where(ok, b2, 1.0))
        keep = ok.to(dtype)
        V[i + 1] = keep * w / b
        BV[i + 1] = keep * bw / b
        alpha[i] = h[i]
        beta[i] = torch.where(ok, b, 0.0)

    if tol is None:
        for i in range(m):
            step(i)
        return V, BV, alpha, beta, W_raw, m

    if nwanted is None:
        raise ValueError("tol requires nwanted")
    min_iter = min(nwanted + 2 if min_iter is None else min_iter, m)
    row = torch.arange(m, device=device)

    def converged(i1):
        # the inactive block decouples: its theta = 0 sort below the
        # wanted (largest) ones
        theta, Y = torch.linalg.eigh(_tridiagonal(
            torch.where(row < i1, alpha, 0.0),
            torch.where(row < i1 - 1, beta, 0.0)))
        sel = torch.argsort(-theta, stable=True)[:nwanted]
        res = torch.abs(beta[i1 - 1] * Y[i1 - 1, sel])
        scale = torch.clamp(torch.max(torch.abs(theta)), min=1.0)
        return host_bool(torch.all(res < tol * scale), "lanczos1_exit")

    i = 0
    while i < m:
        step(i)
        i += 1
        if i % check_every == 0 and i >= min_iter and converged(i):
            loop_exit("lanczos1_exit", "converged", i)
            break
    else:
        loop_exit("lanczos1_exit", "last_step", i)
    # rows from niter on carry no operator information: zero them so the
    # full Rayleigh-Ritz sees an exactly decoupled inactive block
    V[i:] = 0.0
    BV[i:] = 0.0
    return V, BV, alpha, beta, W_raw, i


def lanczos_solve(A, B, factor, sigma, N, m, mode="normal", seed=12345,
                  v0=None, deflate=None, axis=None, tol=None, check_every=8,
                  polish=0) -> LanczosResult:
    """Single-vector shift-invert Lanczos: the N smallest eigenpairs.

    The eigenpairs come from the full Rayleigh-Ritz of the measured
    projected operator ``BV W_raw^T`` (symmetrized). With ``tol`` set the
    iteration may exit early (``lanczos_iteration``); the Ritz values of
    its decoupled inactive block (theta ~ 0) are mapped to +inf so they
    sort last. ``polish`` runs ``polish_ritz_block`` on the selection.
    Outside the normal mode ``tol`` is ignored and all m steps run (the
    exit's largest-theta selection is the normal map's), as in JAX.
    ``mode="cayley"`` iterates the Cayley operator (A - sigma B)^-1
    (A + sigma B) (ARPACK's mode 5): ``factor`` is the normal-mode one.
    With v0=None the start vector is drawn from a ``torch.Generator``
    seeded with ``seed`` (JAX draws from ``jax.random``: parity runs pass
    v0). With ``axis`` the DOF dimension is sharded over its ranks.
    """
    if mode != "normal":
        tol = None
    A = as_operator(A)
    B = as_operator(B)
    dtype = A.dtype
    device = A.device
    if v0 is None:
        v0 = _uniform_block(A.shape[0], 1, seed, dtype, device)[:, 0]
    apply_op = None
    if mode == "cayley":
        def apply_op(v, bv):
            return factor.mv(A.mv(v) + sigma * bv)
    V, BV, alpha, beta, W_raw, niter = lanczos_iteration(
        factor.mv, B.mv, v0, m, deflate=deflate, axis=axis, tol=tol,
        nwanted=N, check_every=check_every, apply_op=apply_op)
    Hf = psum(BV[:m] @ W_raw.T, axis)
    H = 0.5 * (Hf + Hf.T)
    theta, Y = torch.linalg.eigh(H)
    if tol is not None:
        scale = torch.max(torch.abs(theta))
        big = torch.abs(theta) > 1e-12 * scale
        lam_all = torch.where(big, 1.0 / torch.where(big, theta, 1.0)
                              + sigma, torch.inf)
        order = torch.argsort(lam_all, stable=True)
    else:
        lam_all, order = map_ritz_values(theta, sigma, mode)

    sel = order[:N]
    lam = lam_all[sel]
    Y0 = Y[:, sel]
    last = min(max(niter - 1, 0), m - 1)
    eig_res = torch.abs(beta[last] * Y0[last, :])
    Phi = V[:m].T @ Y0
    if polish:
        lam, Phi, eig_res = polish_ritz_block(A, B, factor, lam, Phi, sigma,
                                              mode, deflate=deflate,
                                              axis=axis, nsteps=polish)
    return LanczosResult(
        lam=lam, Phi=Phi, V=V, BV=BV, alpha=alpha, beta=beta, H=H,
        theta=theta, Y=Y, order=order, lam_all=lam_all, eig_res=eig_res,
        sigma=torch.tensor(sigma, dtype=dtype, device=device), niter=niter,
        deflated=deflate is not None)


# ---------------------------------------------------------------------------
# Host wrapper with the reference's class surface
# ---------------------------------------------------------------------------


class BasicLanczos:
    """The reference's ``BasicLanczos`` surface over ``lanczos_solve``:
    ``solve`` / ``solve_adjoint`` / ``eval_adjoint_residual_norm`` /
    ``add_total_derivative`` (``eigd_tpu/ops/lanczos.py:1069-1251``).

    It keeps the result as host state, picks the mode count with
    ``Ntarget`` (N grows until lam[N-1] and lam[N] are distinct, Phi
    widened from the stored basis), warns on a repeated boundary and on
    non-convergence (``fail``), and dispatches the adjoint methods.
    ``adaptive`` lets the iteration exit at ``tol`` (normal mode; one
    counted host decision a check, ``sync.HOST_SYNCS["lanczos1_exit"]``).
    ``ortho_type`` is accepted for the reference's signature; both values
    run the full CGS2 iteration, as in JAX. The start vector comes from a
    ``torch.Generator`` seeded with ``seed``, or is ``v0`` (JAX draws
    another from ``jax.random``: parity runs pass JAX's).
    """

    def __init__(self, N=10, m=60, tol=1e-14, Ntarget=None, eig_atol=1e-5,
                 mode="normal", seed=12345, ortho_type="full",
                 adaptive=False, v0=None):
        if mode not in ("normal", "buckling", "cayley"):
            raise ValueError(f"Unknown mode {mode!r}")
        if Ntarget is not None and not isinstance(Ntarget, int):
            raise ValueError("Ntarget must be an integer or None")
        if ortho_type not in ("full", "selective"):
            raise ValueError(f"Unknown ortho_type {ortho_type!r}")
        self.ortho_type = ortho_type
        self.N = N
        self.m = m
        self.tol = tol
        self.Ntarget = Ntarget
        self.eig_atol = eig_atol
        self.mode = mode
        self.seed = seed
        self.adaptive = adaptive
        self.v0 = v0
        self.res = None

    def solve(self, A, B, factor, sigma):
        """The N wanted eigenpairs of A phi = lam B phi (buckling: the
        load factors of the (G, K) pencil) by shift-invert Lanczos with
        ``factor``. Returns (lam, Phi)."""
        self.A, self.B = as_operator(A), as_operator(B)
        # the Krylov space cannot exceed the problem dimension
        self.m = min(self.m, int(self.A.shape[0]))
        self.factor, self.sigma = factor, sigma

        N = self.Ntarget if self.Ntarget is not None else self.N
        # vectors for the N wanted pairs, with slack for Ntarget growth
        nvec = min(self.m, N + 3) if self.Ntarget is not None else N
        res = lanczos_solve(self.A, self.B, factor, sigma, nvec, self.m,
                            mode=self.mode, seed=self.seed, v0=self.v0,
                            tol=self.tol if self.adaptive else None)
        lam_sorted = res.lam_all[res.order].tolist()
        if self.Ntarget is not None:
            while N < self.m - 1 and abs(
                    lam_sorted[N - 1] - lam_sorted[N]) < self.eig_atol:
                N += 1
            self.N = N
        elif N < self.m and abs(
                lam_sorted[N - 1] - lam_sorted[N]) < self.eig_atol:
            warnings.warn(f"BasicLanczos: Ritz values {N} and {N + 1} are "
                          "numerically repeated.")

        if N > nvec:
            # Ntarget grew past the solved vectors: widen from the basis
            sel = res.order[:N]
            Y0 = res.Y[:, sel]
            last = min(max(res.niter - 1, 0), res.m - 1)
            lam, Phi = res.lam_all[sel], res.V[:res.m].T @ Y0
            eig_res = torch.abs(res.beta[last] * Y0[last, :])
        else:
            lam, Phi, eig_res = res.lam[:N], res.Phi[:, :N], res.eig_res[:N]
        self.res = dataclasses.replace(res, lam=lam, Phi=Phi, eig_res=eig_res)
        self.lam0, self.Phi = lam, Phi
        self.eig_res = eig_res.cpu().numpy()
        self.niter = res.niter
        self.fail = bool((self.eig_res > self.tol).any())
        if self.fail:
            warnings.warn(
                f"BasicLanczos: eigensolve did not converge to tol="
                f"{self.tol:g} (max residual {self.eig_res.max():g} after "
                f"{self.niter} iterations).")
        return self.lam0, self.Phi

    def solve_adjoint(self, Phib, method="sibk", psi=None, rtol=1e-10,
                      atol=1e-30, lanczos_guess=True, **kwargs):
        """psi and its EigCorrection for the adjoint seeds Phib by
        ``method``: "pcpg", "pgmres", "sibk" (each from an LAA guess when
        ``lanczos_guess``), "laa" or "dl". The Cayley map has no adjoint.
        ``kwargs`` go to the iterative solver; its info is kept as
        ``adjoint_info``."""
        from . import adjoint as adj

        if method not in ("pcpg", "pgmres", "sibk", "laa", "dl"):
            raise ValueError(f"Unknown method {method!r}")
        if self.mode == "cayley":
            raise ValueError(
                "cayley is a forward spectral map only; the adjoint solvers "
                "take the normal and buckling modes")
        res = self.res
        Phib = torch.as_tensor(Phib, dtype=res.Phi.dtype,
                               device=res.Phi.device)
        if method == "dl":
            return adj.dl(Phib, self.B, self.factor, res, mode=self.mode,
                          eig_atol=self.eig_atol)
        if lanczos_guess or method == "laa":
            psi = adj.laa(Phib, self.B, self.factor, res, b_ortho=True,
                          mode=self.mode)
        elif psi is None:
            psi = torch.zeros_like(Phib)
        if method == "laa":
            return adj.generate_adjoint_correction(
                res.lam, res.Phi, psi, Phib=Phib, eig_atol=self.eig_atol,
                mode=self.mode)
        solver = {"sibk": adj.sibk, "pcpg": adj.pcpg,
                  "pgmres": adj.pgmres}[method]
        if method == "sibk":
            kwargs.setdefault("sigma", self.sigma)
        psi, data, self.adjoint_info = solver(
            Phib, self.A, self.B, res.lam, res.Phi, mode=self.mode, psi=psi,
            factor=self.factor, rtol=rtol, atol=atol,
            eig_atol=self.eig_atol, **kwargs)
        return psi, data

    def eval_adjoint_residual_norm(self, Phib, psi, b_ortho=False):
        from . import adjoint as adj

        return adj.eval_adjoint_residual_norm(
            self.A, self.B, self.res.lam, self.res.Phi, Phib, psi,
            mode=self.mode, b_ortho=b_ortho)

    def add_total_derivative(self, lamb, Phib, psi, dAdx, dBdx, dfdx,
                             adj_corr_data=None, deriv_type="tensor"):
        from . import adjoint as adj

        return adj.add_eig_total_derivative(
            self.res.lam, self.res.Phi, lamb, Phib, psi, dAdx, dBdx, dfdx,
            adj_corr_data=adj_corr_data, mode=self.mode,
            deriv_type=deriv_type)
