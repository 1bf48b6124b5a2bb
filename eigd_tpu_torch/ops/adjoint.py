"""Eigenvector-adjoint solvers and total-derivative weights.

Counterpart of ``eigd_tpu/ops/adjoint.py``: the repeated-eigenvalue
corrections, the total-derivative weight blocks, the LAA Galerkin guess,
the SIBK shift-invert block-Krylov solver with the mixed-precision ladder,
PCPG, projected GMRES and DL, the reverse sweep through the single-vector
Lanczos recurrence. All N adjoint systems
advance together as (n, N) blocks. JAX's ``while_loop``s become Python
loops whose exits are host decisions (``sync.host_bool``); JAX's ``vmap``
over the N shifted systems (SIBK's least squares, PGMRES's Arnoldi
recurrences) becomes a batch dimension. Every solver takes the normal
mode, A phi = lam B phi, and the buckling mode, the pencil
K phi + lam G phi = 0 with (A, B) = (G, K) and K-orthonormal Phi, whose
adjoint systems are (B + lam_i A) psi_i = -proj(Phib_i), in every solver
but DL (``check_dl_chain``). With ``axis`` (``collective.Axis``) the DOF
dimension of every (n, .) block is sharded over its ranks and every inner
product is all-reduced, so each loop decision reads a replicated value.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from .collective import pdot, psum, qr_tall
from .lanczos import LanczosResult, _tridiagonal
from .operators import as_operator
from .sync import host_bool


# ---------------------------------------------------------------------------
# Correction data for repeated / clustered eigenvalues
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EigCorrection:
    """``Xi[j, i]`` / ``Eta[j, i]`` multiply ``Phi[:, j]`` in the corrected
    direction for mode ``i``; nonzero only on numerically repeated pairs."""

    Xi: torch.Tensor  # (N, N)
    Eta: torch.Tensor  # (N, N)


def no_correction(N, dtype, device="cpu"):
    z = torch.zeros((N, N), dtype=dtype, device=device)
    return EigCorrection(z, z)


def are_eigenvalues_repeated(lam, atol=1e-5):
    """True if any adjacent sorted eigenvalues are within atol."""
    return bool(torch.any(torch.abs(torch.diff(lam)) < atol))


def generate_adjoint_correction(lam, Phi, psi, G=None, Phib=None,
                                eig_atol=1e-5, mode="normal", axis=None):
    """Correct the adjoint solution along the computed eigenvectors.

    Distinct pairs fold directly into psi; numerically repeated pairs get
    (Xi, Eta) coefficients in an EigCorrection. Requires Phi^T B psi = 0.
    In buckling mode the couplings G are scaled by diag(lam).
    Returns (psi_corrected, EigCorrection).
    """
    N = lam.shape[0]
    G0 = -pdot(Phi.T, Phib, axis) if G is None else G
    if mode == "buckling":
        G0 = lam[:, None] * G0
    elif mode != "normal":
        raise ValueError(f"Unknown mode {mode!r}")

    diff = lam[:, None] - lam[None, :]  # diff[j, i] = lam[j] - lam[i]
    eye = torch.eye(N, dtype=torch.bool, device=lam.device)
    close = (torch.abs(diff) < eig_atol) & ~eye
    safe = torch.where(close | eye, 1.0, diff)

    S = torch.where(close | eye, 0.0, G0 / safe)
    psi = psi + Phi @ S

    # repeated pairs, in the separated form of the JAX package (the 0/0
    # divided difference R is floored at the eigenvalue resolution)
    anti = G0 - G0.T
    floor = 1e-9 * (torch.abs(lam)[:, None] + torch.abs(lam)[None, :]) + 1e-30
    mag = torch.maximum(torch.abs(diff), floor)
    signed = torch.where(diff >= 0.0, mag, -mag)
    R = torch.where(close, anti / signed, 0.0)
    Xi = 0.5 * R
    Eta = torch.where(close, 0.5 * lam[None, :] * R - 0.5 * G0.T, 0.0)
    return psi, EigCorrection(Xi=Xi, Eta=Eta)


# JAX's other name for it (eigd_tpu/ops/adjoint.py:134)
apply_adjoint_correction = generate_adjoint_correction


# ---------------------------------------------------------------------------
# Total derivative assembly
# ---------------------------------------------------------------------------


def total_derivative_weights(lam, Phi, lamb, Phib, psi, adj_corr_data=None,
                             mode="normal", axis=None):
    """The (n, N) weight blocks W_A, W_B of the total derivative
    df/dx = dAdx(W_A, Phi) -/+ dBdx(W_B, Phi) (minus in normal mode, plus
    in buckling mode):

        normal:   W_A = Phi diag(lamb) + psi + Phi Xi
                  W_B = Phi diag(beta + lam*lamb) + psi diag(lam) + Phi Eta
        buckling: W_A = Phi diag(lam^2 lamb) + psi diag(lam) + Phi Eta
                  W_B = Phi diag(lam*lamb - beta) + psi + Phi Xi

    with beta_i = 0.5 * phi_i . Phib_i. In buckling mode lamb enters
    scaled by lam: with K phi + lam G phi = 0 and phi^T K phi = 1,
    d(lam) = lam phi^T dK phi + lam^2 phi^T dG phi.
    """
    N = lam.shape[0]
    if adj_corr_data is None:
        adj_corr_data = no_correction(N, Phi.dtype, Phi.device)
    Xi, Eta = adj_corr_data.Xi, adj_corr_data.Eta
    beta = 0.5 * psum(torch.sum(Phi * Phib, dim=0), axis)
    if mode == "normal":
        W_A = Phi * lamb[None, :] + psi + Phi @ Xi
        W_B = (Phi * (beta + lam * lamb)[None, :] + psi * lam[None, :]
               + Phi @ Eta)
    elif mode == "buckling":
        W_A = ((Phi * (lam * lamb)[None, :] + psi) * lam[None, :]
               + Phi @ Eta)
        W_B = Phi * (lam * lamb - beta)[None, :] + psi + Phi @ Xi
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    return W_A, W_B


def add_eig_total_derivative(lam, Phi, lamb, Phib, psi, dAdx, dBdx, dfdx,
                             adj_corr_data=None, mode="normal",
                             deriv_type="tensor", axis=None):
    """dfdx + dAdx(W_A, Phi) -/+ dBdx(W_B, Phi) (minus in normal mode, plus
    in buckling mode) with the weight blocks of
    ``total_derivative_weights``; ``dAdx(W, V)`` contracts
    sum_i w_i^T (dA/dx) v_i. Either callback may be None."""
    del deriv_type  # the batched contraction always
    W_A, W_B = total_derivative_weights(lam, Phi, lamb, Phib, psi,
                                        adj_corr_data=adj_corr_data,
                                        mode=mode, axis=axis)
    if dAdx is not None:
        dfdx = dfdx + dAdx(W_A, Phi)
    if dBdx is not None:
        dB = dBdx(W_B, Phi)
        dfdx = dfdx - dB if mode == "normal" else dfdx + dB
    return dfdx


# ---------------------------------------------------------------------------
# Residual / orthogonality diagnostics
# ---------------------------------------------------------------------------


def eval_adjoint_residual_norm(A, B, lam, Phi, Phib, psi, mode="normal",
                               b_ortho=False, axis=None):
    """res[i] = || A psi_i - lam_i B psi_i - b_i || (buckling mode:
    || B psi_i + lam_i A psi_i - b_i ||),
    b_i = -(Phib_i - B phi_i (phi_i . Phib_i)), and the orthogonality
    |phi_i^T B psi_i| (or max_j |(B phi_j)^T psi_i| if b_ortho)."""
    A, B = as_operator(A), as_operator(B)
    BPhi = B.mv(Phi)
    proj_coef = psum(torch.sum(Phi * Phib, dim=0), axis)
    bmat = -(Phib - BPhi * proj_coef[None, :])
    r = _shifted_mv(A, B, lam, psi, mode) - bmat
    if b_ortho:
        r = r - BPhi @ pdot(Phi.T, r, axis)
        ortho = torch.max(torch.abs(pdot(BPhi.T, psi, axis)), dim=0).values
    else:
        ortho = torch.abs(psum(torch.sum(BPhi * psi, dim=0), axis))
    res = torch.sqrt(psum(torch.sum(r * r, dim=0), axis))
    return res, ortho


# ---------------------------------------------------------------------------
# LAA - Lanczos adjoint approximation (Galerkin in the Lanczos subspace)
# ---------------------------------------------------------------------------


def laa(Phib, B, factor, res: LanczosResult, D0=None, b_ortho=False,
        mode="normal", axis=None, approx=False):
    """Galerkin solution of the adjoint equations in the Lanczos subspace:

    D[i, j] = (Ys_i . Yb_j) / (theta_j - theta_i) (masked), then
    psi = -factor(B V (Ys (D * scale))),  scale = 1/(lam - sigma), or
    sigma/(lam - sigma) in buckling mode. ``D0``, an (m, N) matrix, is
    taken in place of the masked D when given.
    """
    B = as_operator(B)
    m = res.m
    N = Phib.shape[1]
    V = res.V[:m]
    Ys = res.Ys
    theta_s = res.theta_s
    lam = res.lam[:N]
    sigma = res.sigma

    if D0 is not None:
        D = D0
    else:
        C = Ys.T @ pdot(V, Phib, axis)  # (m, N)
        denom = theta_s[None, :N] - theta_s[:, None]
        rows = torch.arange(m, device=V.device)[:, None]
        cols = torch.arange(N, device=V.device)[None, :]
        mask = (rows >= N) if b_ortho else (rows != cols)
        ok = mask & (denom != 0.0)
        D = torch.where(ok, C / torch.where(ok, denom, 1.0), 0.0)
        # directions never measured carry theta = 0: zero their rows
        good = torch.abs(theta_s) > 1e-12 * torch.max(torch.abs(theta_s))
        D = D * good[:, None]
    if mode == "normal":
        scale = 1.0 / (lam - sigma)
    elif mode == "buckling":
        scale = sigma / (lam - sigma)
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    t = Ys @ (D * scale[None, :])
    rhs = B.mv(V.T @ t)
    mv = getattr(factor, "approx_mv", None) if approx else None
    if mv is not None:
        return -mv(rhs.to(torch.float32)).to(Phib.dtype)
    return -factor.mv(rhs)


# ---------------------------------------------------------------------------
# Least-squares helpers for shifted projected systems
# ---------------------------------------------------------------------------


def _lstsq_qr(Amat, b):
    """min || A y - b || via reduced QR; Amat (..., M, K), b (..., M).
    Returns (y, residual norm)."""
    q, r = torch.linalg.qr(Amat)
    y = torch.linalg.solve_triangular(
        r, (q.transpose(-1, -2) @ b[..., None]), upper=True)[..., 0]
    resid = (Amat @ y[..., None])[..., 0] - b
    return y, torch.sqrt(torch.sum(resid * resid, dim=-1))


def _solve_shifted_lstsq(alpha, H0, r):
    """Solve min ||(I - alpha*H0) y - r|| with a rectangular identity."""
    M, K = H0.shape
    eye = torch.eye(M, K, dtype=H0.dtype, device=H0.device)
    return _lstsq_qr(eye - alpha * H0, r)


# ---------------------------------------------------------------------------
# SIBK - shift-invert block Krylov (the flagship adjoint solver)
# ---------------------------------------------------------------------------


def _shifted_mv(A, B, lam, X, mode):
    """The N shifted operators on the columns of X: (A - lam_i B) x_i, or
    (B + lam_i A) x_i in buckling mode."""
    if mode == "normal":
        return A.mv(X) - B.mv(X) * lam[None, :]
    if mode == "buckling":
        return B.mv(X) + A.mv(X) * lam[None, :]
    raise ValueError(f"Unknown mode {mode!r}")


def _projected_adjoint_residual(Phib, A, B, lam, Phi, BPhi, psi, mode,
                                axis=None):
    """R = proj(-Phib - (A - lam B) psi) (buckling: (B + lam A)): the sibk
    outer-round residual."""
    Rm = -Phib - _shifted_mv(A, B, lam, psi, mode)
    return Rm - BPhi @ pdot(Phi.T, Rm, axis)


def sibk_true_resnorm(Phib, A, B, lam, Phi, psi, mode="normal", axis=None):
    """Absolute projected-residual norms of the N adjoint systems."""
    R = _projected_adjoint_residual(Phib, A, B, lam, Phi, B.mv(Phi), psi,
                                    mode, axis)
    return torch.sqrt(psum(torch.sum(R * R, dim=0), axis))


def _sibk_setup(Phib, A, B, lam, Phi, mode="normal", sigma=None,
                factor=None, rtol=1e-10, atol=1e-30, maxiter=50,
                check_every=3, mixed=False, ladder="approx", axis=None):
    """The sibk round machinery: ``one_round(psi, eps_f)`` grows one
    block-Krylov ladder of up to T = ceil(maxiter / N) block steps from the
    projected residual of psi and updates psi by batched shifted
    least-squares; ``true_resnorm`` measures the restart residual. The
    ladder grows on factor then B (normal mode: (A - lam B) z =
    w - (lam - sigma) B z) or factor then A (buckling mode:
    (B + lam A) z = w + (lam - sigma) A z)."""
    A, B = as_operator(A), as_operator(B)
    n, N = Phib.shape
    dtype = Phib.dtype
    device = Phib.device

    BPhi = B.mv(Phi)
    G = -pdot(Phi.T, Phib, axis)
    rnorm0 = torch.sqrt(torch.max(psum(torch.sum(Phib * Phib, dim=0), axis)))
    tol = torch.clamp(rtol * rnorm0, min=atol)

    if mode == "normal":
        alphas = lam - sigma
        ladder_op = B
    elif mode == "buckling":
        alphas = -(lam - sigma)
        ladder_op = A
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    def op_residual(psi_):
        return _projected_adjoint_residual(Phib, A, B, lam, Phi, BPhi, psi_,
                                           mode, axis)

    def true_resnorm(psi_):
        R = op_residual(psi_)
        return torch.sqrt(psum(torch.sum(R * R, dim=0), axis))

    T = max(1, -(-maxiter // N))
    K = T * N
    eyeK = torch.eye(K + N, K, dtype=dtype, device=device)
    eyeK_low = torch.cat([torch.zeros((N, K), dtype=dtype, device=device),
                          torch.eye(K, dtype=dtype, device=device)])
    col = torch.arange(K + N, device=device)

    ldt = torch.float32 if (mixed and dtype == torch.float64) else dtype

    def lcast(x):
        return x.to(ldt)

    # mixed-ladder apply: "approx" = f32 PCG solve, "precond" = one raw
    # V-cycle; the rounds restart on true f64 residuals either way
    approx = None
    if ldt != dtype:
        if ladder == "precond":
            approx = getattr(factor, "precond_mv", None)
        if approx is None:
            approx = getattr(factor, "approx_mv", None)
    factor_lmv = approx if approx is not None else factor.mv
    Phi_l = lcast(Phi)
    BPhi_l = lcast(BPhi)

    def proj_l(X):
        return X - BPhi_l @ pdot(Phi_l.T, X, axis)

    def solve_all(H, r0, cheap=False):
        """Batched shifted least-squares over the (possibly truncated)
        ladder; never-built (all-zero) H columns get unit columns at rows
        >= j+N. cheap=True solves the regularized normal equations."""
        H = H.to(dtype)
        cn = torch.sum(H * H, dim=0)
        unit = (cn == 0.0).to(dtype)
        I_mat = eyeK * (1.0 - unit)[None, :] + eyeK_low * unit[None, :]
        rhs = torch.zeros((K + N, N), dtype=dtype, device=device)
        rhs[:N] = r0.to(dtype)
        Amat = I_mat[None] - alphas[:, None, None] * H[None]  # (N, K+N, K)
        b = rhs.T  # (N, K+N)
        if cheap:
            At = Amat.transpose(-1, -2)
            Gm = At @ Amat
            tr = torch.diagonal(Gm, dim1=-2, dim2=-1).sum(-1)
            Gm = Gm + (1e-14 * tr / K)[:, None, None] * torch.eye(
                K, dtype=dtype, device=device)
            L = torch.linalg.cholesky(Gm)
            z = torch.linalg.solve_triangular(L, At @ b[..., None],
                                              upper=False)
            y = torch.linalg.solve_triangular(L.transpose(-1, -2), z,
                                              upper=True)[..., 0]
            resid = (Amat @ y[..., None])[..., 0] - b
            res = torch.sqrt(torch.sum(resid * resid, dim=-1))
        else:
            y, res = _lstsq_qr(Amat, b)
        return y.T, res  # (K, N), (N,)

    def one_round(psi_, eps_f):
        R = lcast(op_residual(psi_))
        # within-round exit at eps_f * (round residual scale)
        rnorm_round = torch.sqrt(
            torch.max(psum(torch.sum(R * R, dim=0), axis))).to(dtype)
        tol_round = torch.maximum(tol, eps_f * rnorm_round)
        Wseed, r0 = qr_tall(R, axis)  # (n, N), (N, N)
        W = torch.zeros((K + N, n), dtype=ldt, device=device)
        W[:N] = Wseed.T
        Z = torch.zeros((K, n), dtype=ldt, device=device)
        H = torch.zeros((K + N, K), dtype=ldt, device=device)

        def step(t):
            lo = t * N
            Zblk = lcast(factor_lmv(W[lo:lo + N].T))  # (n, N) blocked apply
            w = proj_l(lcast(ladder_op.mv(Zblk)))
            mask = (col < lo + N).to(ldt)
            h1 = pdot(W, w, axis) * mask[:, None]
            w = w - W.T @ h1
            h2 = pdot(W, w, axis) * mask[:, None]
            w = w - W.T @ h2
            w = proj_l(w)
            h = h1 + h2
            Qb, Rb = qr_tall(w, axis)
            W[lo + N:lo + 2 * N] = Qb.T
            Z[lo:lo + N] = Zblk.T
            h[lo + N:lo + 2 * N] = Rb
            H[:, lo:lo + N] = h

        t = 0
        while t < T:
            step(t)
            t += 1
            if t % check_every == 0 and t < T:
                _, res = solve_all(H, r0, cheap=True)
                if host_bool(torch.all(res < tol_round), "sibk_ladder"):
                    break

        Ymat, resids = solve_all(H, r0, cheap=True)
        psi_ = psi_ + (Z.T @ lcast(Ymat)).to(dtype)
        return psi_, resids, t * N

    return types.SimpleNamespace(
        one_round=one_round, true_resnorm=true_resnorm, tol=tol,
        rnorm0=rnorm0, G=G, BPhi=BPhi,
        floor0=(3e-6 if ldt != dtype else 1e-14))


def sibk(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
         factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=50,
         nrestart=2, check_every=3, bs_target=None, update_guess=None,
         callback=None, axis=None, mixed=False, ladder="approx"):
    """Shift-invert block Krylov adjoint solver.

    One shared Krylov space per round for all N right-hand sides; the N
    shifted projected systems (I - alpha_i H) y_i = r_i with
    alpha_i = lam_i - sigma are solved as one batch; up to ``nrestart``
    outer rounds restart from the true residuals and stop on convergence
    or when a round buys less than a 40% reduction. ``mixed=True`` runs the
    ladder in f32 with the factor's approx (or precond) apply.

    ``bs_target``, ``update_guess`` and ``callback`` are the reference's
    keywords, accepted and discarded as JAX's sibk does: the block is
    always all N right-hand sides, every round restarts from the true
    residuals, and ``info["hist"]`` holds what a callback would see.

    Returns (psi, EigCorrection, info) with info = dict(res = final true
    relative residuals, niter, rounds, hist).
    """
    del bs_target, update_guess, callback
    s = _sibk_setup(Phib, A, B, lam, Phi, mode=mode, sigma=sigma,
                    factor=factor, rtol=rtol, atol=atol, maxiter=maxiter,
                    check_every=check_every, mixed=mixed, ladder=ladder,
                    axis=axis)
    N = Phib.shape[1]
    dtype = Phib.dtype
    if psi is None:
        psi = torch.zeros_like(Phib)
    nr = max(1, nrestart)
    hist = torch.full((nr, N), torch.nan, dtype=dtype, device=Phib.device)

    resn = s.true_resnorm(psi)
    eps_f = torch.tensor(s.floor0, dtype=dtype, device=Phib.device)
    contraction = torch.tensor(0.0, dtype=dtype, device=Phib.device)
    rounds, nsteps = 0, 0
    while rounds < nr and host_bool(torch.any(resn > s.tol)
                                    & (contraction < 0.6), "sibk_round"):
        psi, resids, t_end = s.one_round(psi, eps_f)
        hist[rounds] = resids
        resn_new = s.true_resnorm(psi)
        achieved = torch.max(resn_new) / torch.clamp(torch.max(resn),
                                                     min=1e-300)
        eps_f = torch.clamp(0.5 * achieved, s.floor0, 0.5)
        contraction = achieved
        resn = resn_new
        rounds += 1
        nsteps += t_end

    # enforce Phi^T B psi = 0 before the eigendirection fold-in
    psi = psi - Phi @ pdot(s.BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=s.G,
                                            eig_atol=eig_atol, mode=mode)
    denom = torch.clamp(s.rnorm0, min=1e-300)
    info = {"res": resn / denom, "niter": nsteps, "rounds": rounds,
            "hist": hist / denom}
    return psi, data, info


# ---------------------------------------------------------------------------
# PCPG - preconditioned conjugate projected gradient (block form)
# ---------------------------------------------------------------------------


def pcpg(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
         factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=100,
         reset=25, callback=None, axis=None, precond=None, deflate=None):
    """PCPG adjoint solver (Alvin, AIAA J. 1997).

    All N systems advance together with per-column coefficients; converged
    columns freeze, and the loop exits once every column is under
    ``rtol * max ||Phib_i||``: one host decision an iteration
    (``sync.HOST_SYNCS["pcpg"]``). The beta update is flexible
    (Polak-Ribiere) with a hard reset every ``reset`` iterations.

    ``precond``: a cheap apply (f32 in, f32 out) in place of the exact
    ``factor.mv``. ``deflate``: the (U, BU) rows deflated out of the
    forward solve (eigenvalue 0, where the projected operator is
    indefinite); their adjoint components are resolved exactly,
    psi_i += u_r (u_r . Phib_i) / lam_i, and every iterate stays
    B-orthogonal to U.

    ``callback`` is the reference's keyword, accepted and discarded as
    JAX's pcpg does: ``info["hist"]`` holds what it would see.

    Returns (psi, EigCorrection, info) with info = dict(res = final
    relative residuals, niter, hist = per-iteration history).
    """
    del callback
    A, B = as_operator(A), as_operator(B)
    N = Phib.shape[1]
    dtype = Phib.dtype
    if psi is None:
        psi = torch.zeros_like(Phib)

    BPhi = B.mv(Phi)
    rnorm0 = torch.sqrt(torch.max(psum(torch.sum(Phib * Phib, dim=0), axis)))
    tol = torch.clamp(rtol * rnorm0, min=atol)

    if precond is None:
        M = factor.mv
    else:
        def M(Zp):
            return precond(Zp.to(torch.float32)).to(dtype)

    if deflate is not None:
        if mode != "normal":
            raise NotImplementedError(
                "pcpg deflation handling is normal-mode only")
        U, BU = deflate
        psi = psi + U.T @ (pdot(U, Phib, axis) / lam[None, :])

        def defl_r(X):  # residual space: coefficients u_r . X
            return X - BU.T @ pdot(U, X, axis)

        def defl_z(X):  # solution space: coefficients Bu_r . X
            return X - U.T @ pdot(BU, X, axis)
    else:
        def defl_r(X):
            return X

        defl_z = defl_r

    R = -Phib - _shifted_mv(A, B, lam, psi, mode)
    G = pdot(Phi.T, R, axis)
    R = defl_r(R - BPhi @ G)

    hist = torch.full((maxiter, N), torch.nan, dtype=dtype,
                      device=Phib.device)
    Rprev = torch.zeros_like(R)
    P0 = torch.zeros_like(R)
    zTr_prev = torch.ones(N, dtype=dtype, device=Phib.device)
    k = 0
    while k < maxiter and host_bool(
            torch.any(psum(torch.sum(R * R, dim=0), axis) > tol * tol),
            "pcpg"):
        resn = torch.sqrt(psum(torch.sum(R * R, dim=0), axis))
        hist[k] = resn
        active = resn > tol
        Z = M(defl_r(R - BPhi @ pdot(Phi.T, R, axis)))
        Z = defl_z(Z - Phi @ pdot(BPhi.T, Z, axis))
        zTr = psum(torch.sum(Z * R, dim=0), axis)
        if k % reset == 0:
            beta = torch.zeros_like(zTr)
        else:
            zTr_flex = zTr - psum(torch.sum(Z * Rprev, dim=0), axis)
            beta = zTr_flex / torch.where(zTr_prev == 0.0, 1.0, zTr_prev)
        P = Z + beta[None, :] * P0
        tA = A.mv(P)
        tB = B.mv(P)
        if mode == "normal":
            denom = psum(torch.sum(tA * P, dim=0)
                         - lam * torch.sum(tB * P, dim=0), axis)
            tS = tA - tB * lam[None, :]
        else:
            denom = psum(torch.sum(tB * P, dim=0)
                         + lam * torch.sum(tA * P, dim=0), axis)
            tS = tB + tA * lam[None, :]
        step = torch.where(active & (denom > 0.0),
                           zTr / torch.where(denom == 0.0, 1.0, denom), 0.0)
        psi = psi + step[None, :] * P
        Rprev = R
        R = R - step[None, :] * tS
        P0, zTr_prev = P, zTr
        k += 1

    psi = psi - Phi @ pdot(BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=G,
                                            eig_atol=eig_atol, mode=mode)
    denom = torch.clamp(rnorm0, min=1e-300)
    info = {"res": torch.sqrt(psum(torch.sum(R * R, dim=0), axis)) / denom,
            "niter": k, "hist": hist / denom}
    return psi, data, info


# ---------------------------------------------------------------------------
# PGMRES - projected right-preconditioned GMRES, batched over the modes
# ---------------------------------------------------------------------------


def pgmres(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
           factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=50,
           check_every=8, callback=None, axis=None):
    """Projected GMRES adjoint solver: one Arnoldi recurrence a mode on its
    own shifted operator (A - lam_i B) with the factor as the right
    preconditioner, the N recurrences advanced as one batch.

    Every ``check_every`` steps each mode's Hessenberg least-squares
    residual is measured and a converged mode's recurrence freezes (JAX's
    vmapped ``while_loop``); the loop ends when all have converged: one
    host decision a check (``sync.HOST_SYNCS["pgmres"]``). The bases are
    O(N * maxiter * n): a cross-check method at moderate n.

    ``callback`` is the reference's keyword, accepted and discarded as
    JAX's pgmres does: ``info["hist"]`` holds what it would see.

    Returns (psi, EigCorrection, info) with info = dict(res = final
    relative least-squares residuals, niter = steps summed over modes,
    hist = per-check history).
    """
    del callback
    A, B = as_operator(A), as_operator(B)
    n, N = Phib.shape
    dtype = Phib.dtype
    device = Phib.device
    if psi is None:
        psi = torch.zeros_like(Phib)

    BPhi = B.mv(Phi)
    rnorm0 = torch.sqrt(torch.max(psum(torch.sum(Phib * Phib, dim=0), axis)))
    tol = torch.clamp(rtol * rnorm0, min=atol)

    R0 = -Phib - _shifted_mv(A, B, lam, psi, mode)
    G = pdot(Phi.T, R0, axis)
    R0 = R0 - BPhi @ G

    K = maxiter
    col = torch.arange(K + 1, device=device)
    nhist = K // check_every + 1
    sub = torch.zeros((K + 1, K), dtype=dtype, device=device)
    sub[1:] = torch.eye(K, dtype=dtype, device=device)  # unit subdiagonal

    def lstsq(H, beta0):
        # never-built (all-zero) columns get unit subdiagonals, so the
        # least squares stays full rank; their components are zero
        unit = (torch.sum(H * H, dim=1) == 0.0).to(dtype)
        rhs = torch.zeros((N, K + 1), dtype=dtype, device=device)
        rhs[:, 0] = beta0
        return _lstsq_qr(H + sub[None] * unit[:, None, :], rhs)

    beta0 = torch.sqrt(psum(torch.sum(R0 * R0, dim=0), axis))  # (N,)
    W = torch.zeros((N, K + 1, n), dtype=dtype, device=device)
    W[:, 0] = torch.where(beta0 > 0.0, 1.0, 0.0)[:, None] * (
        R0 / torch.where(beta0 == 0.0, 1.0, beta0)[None, :]).T
    H = torch.zeros((N, K + 1, K), dtype=dtype, device=device)
    Z = torch.zeros((N, K, n), dtype=dtype, device=device)
    hist = torch.full((N, nhist), torch.nan, dtype=dtype, device=device)
    done = torch.zeros(N, dtype=torch.bool, device=device)
    niters = torch.zeros(N, dtype=torch.int64, device=device)

    j = 0
    while j < K:
        live = (~done).to(dtype)
        wj = W[:, j].T  # (n, N)
        z = factor.mv(wj - BPhi @ pdot(Phi.T, wj, axis))
        w = _shifted_mv(A, B, lam, z, mode)
        w = (w - BPhi @ pdot(Phi.T, w, axis)).T  # (N, n)
        mask = (col <= j).to(dtype)
        h1 = psum(torch.einsum("ikn,in->ik", W, w), axis) * mask
        w = w - torch.einsum("ik,ikn->in", h1, W)
        h2 = psum(torch.einsum("ikn,in->ik", W, w), axis) * mask
        w = w - torch.einsum("ik,ikn->in", h2, W)
        h = h1 + h2
        nw2 = psum(torch.sum(w * w, dim=1), axis)
        ok = nw2 > 1e-60
        nw = torch.sqrt(torch.where(ok, nw2, 1.0))
        h[:, j + 1] = torch.where(ok, nw, 0.0)
        # a converged mode keeps its state: its rows j+1 stay zero
        W[:, j + 1] = (live * ok.to(dtype))[:, None] * w / nw[:, None]
        H[:, :, j] = live[:, None] * h
        Z[:, j] = live[:, None] * z.T
        niters = niters + (~done).to(torch.int64)
        j += 1
        if j % check_every == 0:
            _, res = lstsq(H, beta0)
            hist[:, j // check_every] = torch.where(
                done, hist[:, j // check_every], res)
            done = done | (res < tol)
            if host_bool(torch.all(done), "pgmres"):
                break

    y, res = lstsq(H, beta0)
    dpsi = torch.einsum("ikn,ik->ni", Z, y)
    use = (beta0 >= tol).to(dtype)
    psi = psi + dpsi * use[None, :]

    psi = psi - Phi @ pdot(BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=G,
                                            eig_atol=eig_atol, mode=mode)
    denom = torch.clamp(rnorm0, min=1e-300)
    info = {"res": res / denom, "niter": niters.sum(), "hist": hist / denom}
    return psi, data, info


# ---------------------------------------------------------------------------
# DL - direct linearization: reverse mode through the Lanczos recurrence
# ---------------------------------------------------------------------------


def check_dl_chain(res: LanczosResult, mode):
    """Raise ValueError where DL's reverse sweep does not differentiate the
    chain: a deflated chain (its forward projects every Krylov vector, the
    sweep does not) and the buckling mode (its reverse recurrence grows
    with the chain length). JAX's ``dl`` returns gradients off by up to
    1e49 there (ROADMAP, faults of the reference)."""
    if res.deflated:
        raise ValueError(
            "adjoint method 'dl' cannot differentiate a deflated Lanczos "
            "chain (rigid modes projected out); use sibk, pcpg or pgmres")
    if mode == "buckling":
        raise ValueError(
            "adjoint method 'dl' is wrong in buckling mode (its reverse "
            "sweep grows with the chain); use sibk, pcpg or pgmres")
    if mode != "normal":
        raise ValueError(f"Unknown mode {mode!r}")


def dl(Phib, B, factor, res: LanczosResult, mode="normal", eig_atol=1e-5):
    """Exact reverse mode through the three-term shift-invert Lanczos
    recurrence of the single-vector chain (``lanczos_solve``), the
    counterpart of ``eigd_tpu/ops/adjoint.py:991-1108``.

    The reverse sweep rebuilds the forward intermediates from the stored
    basis V and the tridiagonal T over the whole allocated chain
    (``res.m`` steps), one factor apply and three B applies a step. The
    seed Rmod = Phib + B Phi G is taken unconditionally; the distinct-pair
    fold of ``generate_adjoint_correction`` restores its in-span part. A
    step whose beta froze to 0 (breakdown) contributes nothing, through a
    guarded division. The masked rank-1 updates are in-place row updates
    of preallocated (m, n) arrays. A chain run far past convergence
    (trailing betas ~ 0) amplifies rounding, as JAX's docstring says.
    Deflated chains and the buckling mode raise (``check_dl_chain``).

    Returns (psi, EigCorrection).
    """
    check_dl_chain(res, mode)
    B = as_operator(B)
    m = res.m
    N = Phib.shape[1]
    V = res.V[:m]  # (m, n) basis rows
    T = _tridiagonal(res.alpha, res.beta)
    Ys = res.Ys
    theta_s = res.theta_s
    lam = res.lam[:N]
    Phi = res.Phi
    device = Phi.device

    BPhi = B.mv(Phi)
    G = -(Phi.T @ Phib)
    Rmod = Phib + BPhi @ G
    Ysel = Ys[:, :N]
    Vb = Ysel @ Rmod.T  # (m, n) cotangent rows of V
    Yb = V @ Rmod  # (m, N)

    # divided differences in sorted coordinates, skipping the diagonal and
    # repeated selected pairs
    rows = torch.arange(m, device=device)[:, None]
    cols = torch.arange(N, device=device)[None, :]
    denom = theta_s[None, :N] - theta_s[:, None]
    lam_pad = res.lam_all[res.order]
    close_sel = (torch.abs(lam_pad[:, None] - lam[None, :]) < eig_atol) & (
        rows < N)
    mask = (rows != cols) & ~close_sel & (denom != 0.0)
    C = Ys.T @ Yb
    Ds = torch.where(mask, C / torch.where(mask, denom, 1.0), 0.0)
    Tb = Ys @ (Ds @ Ysel.T)  # (m, m)

    # reverse sweep
    Vb.addr_(Tb[:, m - 1], B.mv(factor.mv(B.mv(V[m - 1]))))
    u = factor.mv(B.mv(Tb[:, m - 1] @ V))
    Vb[m - 1] += B.mv(u)
    U = torch.zeros_like(Vb)
    for i in range(m - 2, -1, -1):
        lo = max(i - 1, 0)
        # B V T[:, i]: T is tridiagonal, so rows i-1..i+1 of V
        t = B.mv(T[lo:i + 2, i] @ V[lo:i + 2])
        vb = Vb[i + 1]
        beta = T[i + 1, i]
        c0 = V[i + 1] @ vb - beta * Tb[i + 1, i]
        ok = torch.abs(beta) > 1e-30
        sb = (vb - c0 * B.mv(V[i + 1])) * torch.where(
            ok, 1.0 / torch.where(ok, beta, 1.0), 0.0)
        Vb[lo:i + 1].addr_(T[lo:i + 1, i], sb, alpha=-1.0)
        hb = V[:i + 1] @ sb - Tb[:i + 1, i]
        Vb[:i + 1].addr_(hb, t, alpha=-1.0)
        sb = sb - B.mv(hb @ V[:i + 1])
        U[i + 1] = u
        u = factor.mv(sb)
        Vb[i] += B.mv(u)
    U[0] = u

    psi = -(U.T @ (Ysel / (lam - res.sigma)[None, :]))
    psi = psi - Phi @ (BPhi.T @ psi)
    return generate_adjoint_correction(lam, Phi, psi, G=G, eig_atol=eig_atol,
                                       mode=mode)
