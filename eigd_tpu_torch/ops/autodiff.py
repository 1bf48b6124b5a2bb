"""``eigh_gen`` and ``eigh_gen_dense`` as ``torch.autograd.Function``s.

Counterpart of ``eigd_tpu/ops/autodiff.py:36-349``:

    lam, Phi = eigh_gen(theta, problem, cfg)

composes with ``torch.autograd``. The forward pass assembles the operators,
attaches the kernels' plane stencils at the solver boundary, builds the
shift-invert factor (``problem.factor``, or the dense one of
``make_shift_factor``) and runs the Lanczos eigensolve (block, or single
vector for ``block <= 1``), all without autograd. The backward pass runs
the adjoint solve (an LAA guess, then SIBK, PCPG or PGMRES) with the
repeated-eigenvalue correction and chains the matrix cotangents into
theta by ``torch.autograd.grad`` of the bilinear forms
sum_i w_i^T A(theta) phi_i over a fresh, plain assembly. So no kernel is
ever inside the autograd graph, and the kernels need no backward.

``eigh_gen_dense`` takes explicit (A, B) and returns the matrix
cotangents. ``eigh_gen_oracle`` and ``eigh_gen_directional_oracle`` are
the plain dense references of the tests.

Forward mode (``eigh_gen_tangent``, ``staged_jvp``) is the counterpart of
``eigd_tpu/ops/autodiff.py:391-540``: the tangent solves the adjoint's
projected systems with the operator tangents as right-hand sides.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Callable

import torch
from torch.profiler import record_function

from . import adjoint as adj
from .factor import make_shift_factor
from .lanczos import (_normal_mode_only, b_orthonormalize_rows,
                      block_lanczos_solve, lanczos_solve)
from .operators import DenseOperator


@dataclasses.dataclass(frozen=True)
class EighGenConfig:
    """Static configuration of the eigh_gen primitive.

    kernel_mv : attach the kernels' plane stencils to grid operators at the
        solver boundary, so solver-side f64 ``A.mv``/``B.mv`` run on K2 and
        f32 ones on K1. "auto" = on when the operators live on CUDA; "on"
        forces (CPU tensors then run the kernels' plain twins); "off"
        disables. (JAX's ``pallas_mv``; its "interpret" value has no
        counterpart.)
    """

    N: int = 6
    m: int = 60
    sigma: float = 0.0
    mode: str = "normal"
    adjoint_method: str = "sibk"
    adjoint_maxiter: int = 50
    adjoint_rtol: float = 1e-12
    nrestart: int = 2
    eig_atol: float = 1e-5
    factor_kind: str = "cholesky"  # default factor: make_shift_factor kind
    seed: int = 12345
    lanczos_tol: float = None
    block: int = 1  # forward Lanczos block size (p vectors per factor apply)
    adjoint_mixed: bool = False  # f32 SIBK ladder + f64 restarts
    adjoint_ladder: str = "approx"  # mixed-sibk per-step apply
    lanczos_ortho: str = "full"  # "local": 3-term recurrence + Gram-RR
    lanczos_check_every: int = 1  # adaptive-exit check cadence
    polish: int = 0  # Ritz-block subspace-iteration polish steps
    polish_spare: int = 0  # extra Ritz vectors carried through the polish
    lanczos_sweep: str = "exact"  # "approx": inexact f32 sweep + polish
    kernel_mv: str = "auto"


@dataclasses.dataclass(frozen=True)
class EigProblem:
    """Static description of a parameterized generalized eigenproblem.

    assemble(theta) -> (A, B) operators, differentiable in theta.
    nullspace(theta) -> (k, n) rows of a known null space of A (deflated).
    factor(A, B, sigma, mode) -> shift-invert factor.
    v0(theta) -> Lanczos start vector or (n, p) block, optional.
    """

    assemble: Callable
    nullspace: Callable = None
    factor: Callable = None
    v0: Callable = None


def _kernel_ops(A, B, cfg):
    """Solver-boundary operator enhancement: attach the kernels' plane
    stencils (``GridStencilOperator.with_kernels``)."""
    if cfg.kernel_mv == "auto":
        on = getattr(A, "device", torch.device("cpu")).type == "cuda"
    elif cfg.kernel_mv in ("on", "off"):
        on = cfg.kernel_mv == "on"
    else:
        raise ValueError(f"Unknown kernel_mv {cfg.kernel_mv!r}")
    if not on:
        return A, B
    if hasattr(A, "with_kernels") and A.Wp64 is None:
        A = A.with_kernels()
    if hasattr(B, "with_kernels") and B.Wp64 is None:
        B = B.with_kernels()
    return A, B


def _forward_ops(theta, problem, A, B, cfg):
    A, B = _kernel_ops(A, B, cfg)
    if problem.factor is not None:
        factor = problem.factor(A, B, cfg.sigma, cfg.mode)
    else:
        factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                   kind=cfg.factor_kind)
    deflate = None
    if problem.nullspace is not None:
        deflate = b_orthonormalize_rows(problem.nullspace(theta), B.mv)
    v0 = problem.v0(theta) if problem.v0 is not None else None
    if cfg.block <= 1:
        res = lanczos_solve(A, B, factor, cfg.sigma, cfg.N, cfg.m,
                            mode=cfg.mode, seed=cfg.seed, deflate=deflate,
                            tol=cfg.lanczos_tol, v0=v0,
                            check_every=max(cfg.lanczos_check_every, 8),
                            polish=cfg.polish)
        return A, B, res, factor
    res = block_lanczos_solve(A, B, factor, cfg.sigma, cfg.N, cfg.m,
                              cfg.block, mode=cfg.mode, seed=cfg.seed,
                              deflate=deflate, tol=cfg.lanczos_tol, v0=v0,
                              ortho=cfg.lanczos_ortho,
                              check_every=cfg.lanczos_check_every,
                              polish=cfg.polish,
                              polish_spare=cfg.polish_spare,
                              sweep=cfg.lanczos_sweep)
    return A, B, res, factor


def _projected_solve(rhs, A, B, res, factor, cfg, method, deflate=None,
                     tag=None):
    """psi and its correction data for the projected systems with
    right-hand sides ``rhs`` (the adjoint seed, or the tangent's W): an LAA
    guess, then ``method`` ("laa", "sibk", "pcpg" or "pgmres"). ``tag``
    names the profiler ranges of the two stages."""
    def stage(name):
        return record_function(f"{tag}.{name}") if tag else nullcontext()

    with stage("laa"):
        psi0 = adj.laa(rhs, B, factor, res, b_ortho=True, mode=cfg.mode,
                       approx=(cfg.adjoint_mixed
                               and method in ("sibk", "pcpg")))
    with stage(method):
        if method == "laa":
            return adj.generate_adjoint_correction(
                res.lam, res.Phi, psi0, Phib=rhs, eig_atol=cfg.eig_atol,
                mode=cfg.mode)
        kw = dict(mode=cfg.mode, psi=psi0, factor=factor,
                  rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
                  maxiter=cfg.adjoint_maxiter)
        if method == "sibk":
            psi, data, _ = adj.sibk(
                rhs, A, B, res.lam, res.Phi, sigma=res.sigma,
                nrestart=cfg.nrestart, mixed=cfg.adjoint_mixed,
                ladder=cfg.adjoint_ladder, **kw)
        elif method == "pcpg":
            # mixed: one f32 V-cycle (or f32 solve) a step in place of the
            # exact apply; CG carries the convergence control
            precond = None
            if cfg.adjoint_mixed:
                precond = (getattr(factor, "precond_mv", None)
                           or getattr(factor, "approx_mv", None))
            psi, data, _ = adj.pcpg(rhs, A, B, res.lam, res.Phi,
                                    precond=precond, deflate=deflate, **kw)
        elif method == "pgmres":
            psi, data, _ = adj.pgmres(rhs, A, B, res.lam, res.Phi, **kw)
        else:
            raise ValueError(f"Unknown adjoint method {method!r}")
    return psi, data


def solve_eig_adjoint(A, B, res, factor, lam_bar, Phi_bar, cfg,
                      deflate=None):
    """Reverse-pass core: adjoint solve + correction + weight blocks.

    ``deflate``: the (U, BU) rows deflated out of the forward solve; pcpg
    resolves those components explicitly. Returns (W_A, W_B, Phi) such
    that the matrix cotangents are A_bar = W_A Phi^T and
    B_bar = -W_B Phi^T (normal mode).
    """
    if cfg.adjoint_method == "dl":
        raise NotImplementedError(
            "adjoint_method='dl' is not ported (ROADMAP queue 1, item 12)")
    psi, data = _projected_solve(Phi_bar, A, B, res, factor, cfg,
                                 cfg.adjoint_method, deflate=deflate)
    W_A, W_B = adj.total_derivative_weights(
        res.lam, res.Phi, lam_bar, Phi_bar, psi, adj_corr_data=data,
        mode=cfg.mode)
    return W_A, W_B, res.Phi


def _keep_solve(ctx, A, B, res, factor, *inputs):
    """Keep the forward solve on ctx for the backward pass.

    lam and Phi are the Function's outputs, so they go through
    ``save_for_backward``: an output held in a ctx attribute closes a
    cycle through the autograd node that Python's gc cannot see, and the
    whole solve (the Lanczos basis of every evaluation) would outlive the
    graph. The reverse pass never reads res.BV: the (m, n) buffer is
    dropped."""
    ctx.save_for_backward(*inputs, res.lam, res.Phi)
    ctx.solve = (A, B, dataclasses.replace(res, lam=None, Phi=None, BV=None),
                 factor)


def _kept_solve(ctx):
    """(inputs, (A, B, res, factor)) as ``_keep_solve`` kept them."""
    *inputs, lam, Phi = ctx.saved_tensors
    A, B, res, factor = ctx.solve
    return inputs, (A, B, dataclasses.replace(res, lam=lam, Phi=Phi), factor)


def _zero_seeds(res, lam_bar, Phi_bar):
    if lam_bar is None:
        lam_bar = torch.zeros_like(res.lam)
    if Phi_bar is None:
        Phi_bar = torch.zeros_like(res.Phi)
    return lam_bar, Phi_bar


class EighGenDense(torch.autograd.Function):
    """N smallest eigenpairs of dense A phi = lam B phi."""

    @staticmethod
    def forward(ctx, A, B, cfg):
        factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                   kind=cfg.factor_kind)
        Aop, Bop = DenseOperator(A), DenseOperator(B)
        res = lanczos_solve(Aop, Bop, factor, cfg.sigma, cfg.N, cfg.m,
                            mode=cfg.mode, seed=cfg.seed)
        _keep_solve(ctx, Aop, Bop, res, factor)
        ctx.cfg = cfg
        return res.lam, res.Phi

    @staticmethod
    def backward(ctx, lam_bar, Phi_bar):
        _, (A, B, res, factor) = _kept_solve(ctx)
        lam_bar, Phi_bar = _zero_seeds(res, lam_bar, Phi_bar)
        W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar,
                                          Phi_bar, ctx.cfg)
        return W_A @ Phi.T, -(W_B @ Phi.T), None


def eigh_gen_dense(A, B, cfg: EighGenConfig):
    """N smallest eigenpairs of A phi = lam B phi for dense (n, n) A, B,
    with the adjoint backward pass: A_bar = W_A Phi^T and
    B_bar = -W_B Phi^T."""
    return EighGenDense.apply(A, B, cfg)


class EighGen(torch.autograd.Function):
    """N smallest eigenpairs of A(theta) phi = lam B(theta) phi."""

    @staticmethod
    def forward(ctx, theta, problem, cfg):
        A, B = problem.assemble(theta)
        A, B, res, factor = _forward_ops(theta, problem, A, B, cfg)
        _keep_solve(ctx, A, B, res, factor, theta)
        ctx.problem, ctx.cfg = problem, cfg
        return res.lam, res.Phi

    @staticmethod
    def backward(ctx, lam_bar, Phi_bar):
        (theta,), (A, B, res, factor) = _kept_solve(ctx)
        lam_bar, Phi_bar = _zero_seeds(res, lam_bar, Phi_bar)
        deflate = None
        if (ctx.problem.nullspace is not None
                and ctx.cfg.adjoint_method == "pcpg"):
            deflate = b_orthonormalize_rows(ctx.problem.nullspace(theta),
                                            B.mv)
        W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar,
                                          Phi_bar, ctx.cfg, deflate=deflate)
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            A2, B2 = ctx.problem.assemble(th)
            f = torch.sum(W_A * A2.mv(Phi)) - torch.sum(W_B * B2.mv(Phi))
            (theta_bar,) = torch.autograd.grad(f, th)
        return theta_bar, None, None


def eigh_gen(theta, problem: EigProblem, cfg: EighGenConfig):
    """N smallest eigenpairs of A(theta) phi = lam B(theta) phi, with the
    adjoint backward pass."""
    return EighGen.apply(theta, problem, cfg)


# ---------------------------------------------------------------------------
# Forward mode: the tangent of the eigensolve
# ---------------------------------------------------------------------------


def eigh_gen_tangent(theta, dtheta, problem, cfg, fwd=None):
    """Forward-mode tangent of ``eigh_gen`` along dtheta (normal mode).

    Counterpart of ``eigd_tpu/ops/autodiff.py:391-485``. With B-orthonormal
    eigenvectors and W_i = (dA - lam_i dB) phi_i:

      dlam_i = phi_i^T W_i
      dphi_i = v_i + sum_j c_ij phi_j

    where v_i solves the projected singular system (A - lam_i B) v_i =
    -(I - B Phi Phi^T) W_i, the same systems as the adjoint, by the
    configured adjoint method with W as the right-hand side; the distinct
    solved-pair couplings (phi_j^T W_i)/(lam_i - lam_j) fold into v_i there,
    and inside numerically repeated clusters (and on the diagonal) the
    coupling is -1/2 phi_j^T dB phi_i. ``fwd``, if given, is the forward
    solve ``(A, B, res, factor)`` to reuse (``staged_jvp``). Nothing here is
    recorded by autograd.

    Returns (lam, Phi, dlam, dPhi).
    """
    if cfg.mode != "normal":
        raise NotImplementedError(
            f"mode={cfg.mode!r}: only the normal-mode tangent is ported "
            "(ROADMAP queue 1, item 14 lists buckling)")
    with torch.no_grad():
        if fwd is None:
            A, B = problem.assemble(theta)
            A, B, res, factor = _forward_ops(theta, problem, A, B, cfg)
        else:
            A, B, res, factor = fwd
        lam, Phi = res.lam, res.Phi

    # dA Phi and dB Phi by forward-mode AD of the plain assembly applied to
    # the solved eigenvectors (mv is linear in the assembled data).
    # torch.func.jvp, because every op of the assembly has a forward-AD
    # formula, the stencil build's in-place slice adds included; the
    # double-vjp form would run the assembly's backward twice for nothing.
    def apply_both(th):
        A2, B2 = problem.assemble(th)
        return A2.mv(Phi), B2.mv(Phi)

    with record_function("eigh_gen_tangent.operators"):
        _, (dAP, dBP) = torch.func.jvp(apply_both, (theta.detach(),),
                                       (dtheta.detach(),))

    with torch.no_grad():
        W = dAP - dBP * lam[None, :]  # W[:, i] = (dA - lam_i dB) phi_i
        dlam = torch.sum(Phi * W, dim=0)
        # as in JAX, a method the tangent has no use for (dl) solves by
        # sibk; pcpg runs without the deflation handling, as there
        method = cfg.adjoint_method
        if method not in ("laa", "sibk", "pcpg", "pgmres"):
            method = "sibk"
        psi, _ = _projected_solve(W, A, B, res, factor, cfg, method,
                                  tag="eigh_gen_tangent")
        # the repeated-cluster and diagonal part the projected solve cannot
        # carry: the symmetric -dB/2 coupling
        dBG = Phi.T @ dBP
        close = torch.abs(lam[:, None] - lam[None, :]) < cfg.eig_atol
        Cd = torch.where(close, -0.5 * dBG, 0.0)
        dPhi = psi + Phi @ Cd
    return lam, Phi, dlam, dPhi


def staged_jvp(pre, tail, problem: EigProblem, cfg: EighGenConfig):
    """Directional derivative of ``x -> tail(eigh_gen(pre(x)))`` by forward
    mode: the jvp-vs-vjp oracle of the 1M-DOF problem.

    Counterpart of ``eigd_tpu/ops/autodiff.py:496-540``. The forward
    eigensolve runs once and its (A, B, res, factor) feed the tangent
    solve; both modes share the primal solve, so |jvp - g.p| isolates
    solver and derivation error with no FD step. Returns
    ``fn(x, p) -> (value, dvalue)``. Its stages are ``torch.profiler``
    ranges (``staged_jvp.*``, ``eigh_gen_tangent.*``).
    """
    def fn(x, p):
        with torch.no_grad(), record_function("staged_jvp.forward"):
            theta = pre(x)
            A, B = problem.assemble(theta)
            fwd = _forward_ops(theta, problem, A, B, cfg)
        with record_function("staged_jvp.pre"):
            theta, dtheta = torch.func.jvp(pre, (x,), (p,))
        lam, Phi, dlam, dPhi = eigh_gen_tangent(theta, dtheta, problem, cfg,
                                                fwd=fwd)
        with record_function("staged_jvp.tail"):
            return torch.func.jvp(tail, (lam, Phi), (dlam, dPhi))

    return fn


# ---------------------------------------------------------------------------
# Dense references of the tests (plain torch, Cholesky-transformed pencil)
# ---------------------------------------------------------------------------


def _cholesky_pencil(A, B):
    """(L, w, y): B = L L^T and the symmetric eigendecomposition of
    C = L^-1 A L^-T, so A phi = w B phi with phi = L^-T y."""
    L = torch.linalg.cholesky(B)
    C = torch.linalg.solve_triangular(L, A, upper=False)
    C = torch.linalg.solve_triangular(L, C.T, upper=False)
    w, y = torch.linalg.eigh(0.5 * (C + C.T))
    return L, w, y


def eigh_gen_oracle(A, B, N, mode="normal"):
    """The N smallest eigenpairs of A phi = lam B phi by the Cholesky
    transform and ``torch.linalg.eigh``, differentiable by torch's own
    rules (simple eigenvalues only): the gradient oracle of the tests."""
    _normal_mode_only(mode)
    L, w, y = _cholesky_pencil(A, B)
    phi = torch.linalg.solve_triangular(L.T, y[:, :N], upper=True)
    return w[:N], phi


def eigh_gen_directional_oracle(A, B, dA, dB, N, eig_atol=1e-5,
                                mode="normal"):
    """Directional derivative of the N smallest eigenpairs along (dA, dB),
    with the reference's complex-step semantics: the coupling of a
    numerically repeated pair (|lam_j - lam_i| <= eig_atol) keeps only its
    symmetric part -1/2 phi_j^T dB phi_i, as on the diagonal.

    Returns (lam, Phi, dlam, dPhi) for the N selected modes.
    """
    _normal_mode_only(mode)
    with torch.no_grad():
        L, lam, y = _cholesky_pencil(A, B)
        Phi = torch.linalg.solve_triangular(L.T, y, upper=True)
        P = Phi[:, :N]
        W = dA @ P - (dB @ P) * lam[None, :N]  # W_i = (dA - lam_i dB) phi_i
        dlam = torch.sum(P * W, dim=0)
        diff = lam[None, :N] - lam[:, None]  # [j, i] = lam_i - lam_j
        far = torch.abs(diff) > eig_atol
        C = torch.where(far, (Phi.T @ W) / torch.where(far, diff, 1.0),
                        -0.5 * (Phi.T @ (dB @ P)))
        return lam[:N], P, dlam, Phi @ C
