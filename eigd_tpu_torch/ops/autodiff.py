"""``eigh_gen`` and ``eigh_gen_dense`` as ``torch.autograd.Function``s.

Counterpart of ``eigd_tpu/ops/autodiff.py:36-349``:

    lam, Phi = eigh_gen(theta, problem, cfg)

composes with ``torch.autograd``; theta is a tensor or a tuple of tensors
(buckling's (rhoE, u)). The forward pass assembles the operators,
attaches the kernels' plane stencils at the solver boundary, builds the
shift-invert factor (``problem.factor``, or the dense one of
``make_shift_factor``) and runs the Lanczos eigensolve (block, or single
vector for ``block <= 1``), all without autograd. The backward pass runs
the adjoint solve (an LAA guess, then SIBK, PCPG or PGMRES; or DL, the
reverse sweep through the single-vector chain) with the
repeated-eigenvalue correction and chains the matrix cotangents into
theta by ``torch.autograd.grad`` of the bilinear forms
sum_i w_i^T A(theta) phi_i -/+ sum_i v_i^T B(theta) phi_i (minus in the
normal mode, plus in the buckling mode) over a fresh, plain assembly,
taken part by part where the problem offers ``assemble_parts``. So no
kernel is ever inside the autograd graph, and the kernels need no
backward.

``eigh_gen_dense`` takes explicit (A, B) and returns the matrix
cotangents. ``eigh_gen_oracle`` and ``eigh_gen_directional_oracle`` are
the plain dense references of the tests. ``solve_spd`` is the static
solve u = K(theta)^{-1} f with a hand-written reverse and forward rule.

Forward mode (``eigh_gen_tangent``, ``eigh_gen_fwdmode``, ``staged_jvp``)
is the counterpart of ``eigd_tpu/ops/autodiff.py:358-540``: the tangent
solves the adjoint's projected systems with the operator tangents as
right-hand sides.
"""

from __future__ import annotations

import dataclasses
import types
from contextlib import nullcontext
from typing import Callable

import torch

from . import adjoint as adj
from .collective import pdot, psum
from .factor import make_shift_factor
from .lanczos import b_orthonormalize_rows, block_lanczos_solve, lanczos_solve
from .operators import DenseOperator
from .sync import span


@dataclasses.dataclass(frozen=True)
class EighGenConfig:
    """Static configuration of the eigh_gen primitive.

    kernel_mv : attach the kernels' plane stencils to grid operators at the
        solver boundary, so solver-side f64 ``A.mv``/``B.mv`` run on K2 and
        f32 ones on K1. "auto" = on when the operators live on CUDA; "on"
        forces (CPU tensors then run the kernels' plain twins); "off"
        disables. (JAX's ``pallas_mv``; its "interpret" value has no
        counterpart.)
    axis : the shard axis (``collective.Axis``) when the DOF dimension is
        sharded over the ranks of a process group (the counterpart of JAX's
        shard_map mesh-axis name); None is the single-device path.
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
    measure_eig_res: bool = False  # block solver at polish 0: measure the
    # true pencil residual into LanczosResult.eig_res_measured
    kernel_mv: str = "auto"
    axis: object = None


@dataclasses.dataclass(frozen=True)
class EigProblem:
    """Static description of a parameterized generalized eigenproblem.

    assemble(theta) -> (A, B) operators, differentiable in theta.
    nullspace(theta) -> (k, n) rows of a known null space of A (deflated).
    factor(A, B, sigma, mode) -> shift-invert factor.
    v0(theta) -> Lanczos start vector or (n, p) block, optional.
    assemble_parts(theta) -> an iterator of (A_k, B_k) operators, built
        one at a time, whose sums are assemble(theta); optional. The
        backward pass then takes the bilinear-form VJP part by part, so
        only one part's autograd graph is alive at a time.
    """

    assemble: Callable
    nullspace: Callable = None
    factor: Callable = None
    v0: Callable = None
    assemble_parts: Callable = None


def kernels_on(kernel_mv, device):
    """Whether solver-side stencils on ``device`` run on the kernels under
    ``EighGenConfig.kernel_mv``."""
    if kernel_mv == "auto":
        return torch.device(device).type == "cuda"
    if kernel_mv in ("on", "off"):
        return kernel_mv == "on"
    raise ValueError(f"Unknown kernel_mv {kernel_mv!r}")


def _kernel_ops(A, B, cfg):
    """Solver-boundary operator enhancement: attach the kernels' plane
    stencils (``GridStencilOperator.with_kernels``)."""
    if not kernels_on(cfg.kernel_mv,
                      getattr(A, "device", torch.device("cpu"))):
        return A, B
    if hasattr(A, "with_kernels") and A.Wp64 is None:
        A = A.with_kernels()
    if hasattr(B, "with_kernels") and B.Wp64 is None:
        B = B.with_kernels()
    return A, B


def _forward_ops(theta, problem, A, B, cfg):
    A, B = _kernel_ops(A, B, cfg)
    with span("eigd.factor.build"):
        if problem.factor is not None:
            factor = problem.factor(A, B, cfg.sigma, cfg.mode)
        else:
            factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                       kind=cfg.factor_kind)
    with span("eigd.eig.lanczos"):
        deflate = None
        if problem.nullspace is not None:
            deflate = b_orthonormalize_rows(problem.nullspace(theta), B.mv,
                                            axis=cfg.axis)
        v0 = problem.v0(theta) if problem.v0 is not None else None
        if cfg.block <= 1:
            res = lanczos_solve(A, B, factor, cfg.sigma, cfg.N, cfg.m,
                                mode=cfg.mode, seed=cfg.seed,
                                deflate=deflate, axis=cfg.axis,
                                tol=cfg.lanczos_tol, v0=v0,
                                check_every=max(cfg.lanczos_check_every, 8),
                                polish=cfg.polish)
        else:
            res = block_lanczos_solve(
                A, B, factor, cfg.sigma, cfg.N, cfg.m, cfg.block,
                mode=cfg.mode, seed=cfg.seed, deflate=deflate, axis=cfg.axis,
                tol=cfg.lanczos_tol, v0=v0, ortho=cfg.lanczos_ortho,
                check_every=cfg.lanczos_check_every, polish=cfg.polish,
                polish_spare=cfg.polish_spare, sweep=cfg.lanczos_sweep,
                measure_res=cfg.measure_eig_res)
    return A, B, res, factor


def _projected_solve(rhs, A, B, res, factor, cfg, method, deflate=None,
                     tag=None):
    """psi and its correction data for the projected systems with
    right-hand sides ``rhs`` (the adjoint seed, or the tangent's W): an LAA
    guess, then ``method`` ("laa", "sibk", "pcpg" or "pgmres"). ``tag``
    names the spans of the two stages."""
    def stage(name):
        return span(f"{tag}.{name}") if tag else nullcontext()

    with stage("laa"):
        psi0 = adj.laa(rhs, B, factor, res, b_ortho=True, mode=cfg.mode,
                       approx=(cfg.adjoint_mixed
                               and method in ("sibk", "pcpg")),
                       axis=cfg.axis)
    with stage(method):
        if method == "laa":
            return adj.generate_adjoint_correction(
                res.lam, res.Phi, psi0, Phib=rhs, eig_atol=cfg.eig_atol,
                mode=cfg.mode, axis=cfg.axis)
        kw = dict(mode=cfg.mode, psi=psi0, factor=factor,
                  rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
                  maxiter=cfg.adjoint_maxiter, axis=cfg.axis)
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


@span("eigd.adjoint.solve")
def solve_eig_adjoint(A, B, res, factor, lam_bar, Phi_bar, cfg,
                      deflate=None):
    """Reverse-pass core: adjoint solve + correction + weight blocks.

    ``deflate``: the (U, BU) rows deflated out of the forward solve; pcpg
    resolves those components explicitly. ``dl`` runs the reverse sweep
    through the single-vector chain: it raises on a block solve (no
    three-term chain), a deflated chain, the buckling mode and a sharded
    solve (its sweep reduces over the local shard only). Returns
    (W_A, W_B, Phi) such that the matrix cotangents are A_bar = W_A Phi^T
    and B_bar = -W_B Phi^T (normal mode), +W_B Phi^T (buckling mode).
    """
    if cfg.adjoint_method == "dl":
        if cfg.block > 1:
            raise ValueError(
                "adjoint_method='dl' requires the single-vector Lanczos "
                "solver (block=1); the block solver has no three-term chain")
        if cfg.axis is not None:
            raise ValueError(
                "adjoint_method='dl' has no sharded form (its reverse sweep "
                "takes unreduced inner products); use sibk, pcpg or pgmres")
        adj.check_dl_chain(res, cfg.mode)
        psi, data = adj.dl(Phi_bar, B, factor, res, mode=cfg.mode,
                           eig_atol=cfg.eig_atol)
    else:
        psi, data = _projected_solve(Phi_bar, A, B, res, factor, cfg,
                                     cfg.adjoint_method, deflate=deflate)
    W_A, W_B = adj.total_derivative_weights(
        res.lam, res.Phi, lam_bar, Phi_bar, psi, adj_corr_data=data,
        mode=cfg.mode, axis=cfg.axis)
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
        with span("eigd.factor.build"):
            factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                       kind=cfg.factor_kind)
        Aop, Bop = DenseOperator(A), DenseOperator(B)
        with span("eigd.eig.lanczos"):
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
        B_bar = W_B @ Phi.T
        return (W_A @ Phi.T, -B_bar if ctx.cfg.mode == "normal" else B_bar,
                None)


def eigh_gen_dense(A, B, cfg: EighGenConfig):
    """N smallest eigenpairs of A phi = lam B phi for dense (n, n) A, B
    (buckling mode: the N lowest load factors of B phi + lam A phi = 0),
    with the adjoint backward pass: A_bar = W_A Phi^T and
    B_bar = -/+ W_B Phi^T."""
    return EighGenDense.apply(A, B, cfg)


def _add_bars(a, b):
    """a + b of two gradients of ``allow_unused`` (None for a leaf the
    part does not reach)."""
    if a is None or b is None:
        return b if a is None else a
    return a + b


class EighGen(torch.autograd.Function):
    """N smallest eigenpairs of A(theta) phi = lam B(theta) phi. theta
    arrives as its leaves: one tensor, or the tensors of a tuple
    (``packed``), each of which gets its gradient."""

    @staticmethod
    def forward(ctx, problem, cfg, packed, *leaves):
        theta = leaves if packed else leaves[0]
        A, B = problem.assemble(theta)
        A, B, res, factor = _forward_ops(theta, problem, A, B, cfg)
        _keep_solve(ctx, A, B, res, factor, *leaves)
        ctx.problem, ctx.cfg, ctx.packed = problem, cfg, packed
        return res.lam, res.Phi

    @staticmethod
    def backward(ctx, lam_bar, Phi_bar):
        leaves, (A, B, res, factor) = _kept_solve(ctx)
        lam_bar, Phi_bar = _zero_seeds(res, lam_bar, Phi_bar)
        deflate = None
        if (ctx.problem.nullspace is not None
                and ctx.cfg.adjoint_method == "pcpg"):
            theta = tuple(leaves) if ctx.packed else leaves[0]
            deflate = b_orthonormalize_rows(ctx.problem.nullspace(theta),
                                            B.mv, axis=ctx.cfg.axis)
        W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar,
                                          Phi_bar, ctx.cfg, deflate=deflate)
        with torch.enable_grad():
            ths = [t.detach().requires_grad_(True) for t in leaves]
            theta = tuple(ths) if ctx.packed else ths[0]
            if ctx.problem.assemble_parts is None:
                parts = [ctx.problem.assemble(theta)]
            else:
                parts = ctx.problem.assemble_parts(theta)
            bars = None
            for A2, B2 in parts:
                fA = torch.sum(W_A * A2.mv(Phi))
                fB = torch.sum(W_B * B2.mv(Phi))
                f = fA - fB if ctx.cfg.mode == "normal" else fA + fB
                g = torch.autograd.grad(f, ths, allow_unused=True)
                # the part and its graph go before the next part is built
                del A2, B2, fA, fB, f
                bars = g if bars is None else tuple(map(_add_bars, bars, g))
        return (None, None, None, *bars)


def eigh_gen(theta, problem: EigProblem, cfg: EighGenConfig):
    """N smallest eigenpairs of A(theta) phi = lam B(theta) phi, with the
    adjoint backward pass; theta is a tensor or a tuple of tensors."""
    if isinstance(theta, (tuple, list)):
        return EighGen.apply(problem, cfg, True, *theta)
    return EighGen.apply(problem, cfg, False, theta)


class SolveSPD(torch.autograd.Function):
    """u = K(theta)^{-1} f through a factor that autograd does not see
    (``solve_spd``). The factor is built in ``forward`` and handed to
    ``setup_context`` through ``box``, an object that torch.func's pytree
    handling passes through as it is (a list would be copied). Under a
    profiler ``forward`` is the span ``eigd.static.solve`` (the factor's
    build inside it is an ``eigd.factor.build``) and ``backward``, the
    path adjoint, is ``eigd.static.adjoint``."""

    @staticmethod
    @span("eigd.static.solve")
    def forward(theta, f, build_op, build_factor, box):
        with span("eigd.factor.build"):
            fac = build_factor(theta)
        box.fac = fac
        return fac.mv(f)

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, _, build_op, _, box = inputs
        # torch.func's transforms may set up more than one ctx per call
        ctx.fac, ctx.build_op = box.fac, build_op
        ctx.save_for_backward(theta, output)
        ctx.save_for_forward(theta, output)

    @staticmethod
    @span("eigd.static.adjoint")
    def backward(ctx, u_bar):
        theta, u = ctx.saved_tensors
        w = ctx.fac.mv(u_bar)
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            bilin = -torch.sum(w * ctx.build_op(th).mv(u))
            (theta_bar,) = torch.autograd.grad(bilin, th)
        return theta_bar, w, None, None, None

    @staticmethod
    def jvp(ctx, dtheta, df, *_):
        theta, u = ctx.saved_tensors
        rhs = torch.zeros_like(u) if df is None else df
        if dtheta is not None:
            rhs = rhs - _op_tangent(ctx.build_op, theta, dtheta, u)
        return ctx.fac.mv(rhs)


def _op_tangent(build_op, theta, dtheta, u):
    """dK u: the tangent of build_op(theta).mv(u) along dtheta, by forward
    mode through the plain assembly."""
    _, dKu = torch.func.jvp(lambda th: build_op(th).mv(u),
                            (theta.detach(),), (dtheta.detach(),))
    return dKu


def solve_spd(theta, f, build_op, build_factor):
    """u = K(theta)^{-1} f with the self-adjoint rules of
    ``eigd_tpu/ops/autodiff.py:1041-1100`` (``solve_spd`` and
    ``solve_spd_fwdmode`` in one function):

        reverse: w = K^{-1} u_bar;  theta_bar = -grad_theta(w^T K(theta) u);
                 f_bar = w
        forward: du = K^{-1} (df - dK u)

    build_op(theta) -> operator, differentiable in theta (a tensor);
    build_factor(theta) -> factor with ``mv``, not differentiated. So
    ``torch.func.jvp`` (``staged_jvp``) and ``torch.autograd`` both pass
    through the solve."""
    return SolveSPD.apply(theta, f, build_op, build_factor,
                          types.SimpleNamespace(fac=None))


# ---------------------------------------------------------------------------
# Forward mode: the tangent of the eigensolve
# ---------------------------------------------------------------------------


def eigh_gen_tangent(theta, dtheta, problem, cfg, fwd=None):
    """Forward-mode tangent of ``eigh_gen`` along dtheta (a tensor, or a
    tuple like theta).

    Counterpart of ``eigd_tpu/ops/autodiff.py:391-485``. With B-orthonormal
    eigenvectors and W_i = (dA - lam_i dB) phi_i:

      dlam_i = phi_i^T W_i
      dphi_i = v_i + sum_j c_ij phi_j

    where v_i solves the projected singular system (A - lam_i B) v_i =
    -(I - B Phi Phi^T) W_i, the same systems as the adjoint, by the
    configured adjoint method with W as the right-hand side; the distinct
    solved-pair couplings (phi_j^T W_i)/(lam_i - lam_j) fold into v_i there,
    and inside numerically repeated clusters (and on the diagonal) the
    coupling is -1/2 phi_j^T dB phi_i. In buckling mode ((A, B) = (G, K),
    K-orthonormal Phi) W_i = (dB + lam_i dA) phi_i, dlam_i =
    lam_i phi_i^T W_i, and v_i solves (B + lam_i A) v_i = -proj(W_i).
    ``fwd``, if given, is the forward solve ``(A, B, res, factor)`` to
    reuse (``staged_jvp``). Nothing here is recorded by autograd.

    Returns (lam, Phi, dlam, dPhi).
    """
    if cfg.mode not in ("normal", "buckling"):
        raise NotImplementedError(
            f"mode={cfg.mode!r} has no tangent rule (normal and buckling "
            "have)")
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

    def detached(t):
        if isinstance(t, (tuple, list)):
            return tuple(v.detach() for v in t)
        return t.detach()

    with span("eigh_gen_tangent.operators"):
        _, (dAP, dBP) = torch.func.jvp(apply_both, (detached(theta),),
                                       (detached(dtheta),))

    with torch.no_grad():
        if cfg.mode == "buckling":
            W = dBP + dAP * lam[None, :]  # W[:, i] = (dB + lam_i dA) phi_i
            dlam = lam * psum(torch.sum(Phi * W, dim=0), cfg.axis)
        else:
            W = dAP - dBP * lam[None, :]  # W[:, i] = (dA - lam_i dB) phi_i
            dlam = psum(torch.sum(Phi * W, dim=0), cfg.axis)
        # as in JAX, a method the tangent has no use for (dl) solves by
        # sibk; pcpg runs without the deflation handling, as there
        method = cfg.adjoint_method
        if method not in ("laa", "sibk", "pcpg", "pgmres"):
            method = "sibk"
        psi, _ = _projected_solve(W, A, B, res, factor, cfg, method,
                                  tag="eigh_gen_tangent")
        # the repeated-cluster and diagonal part the projected solve cannot
        # carry: the symmetric -dB/2 coupling
        dBG = pdot(Phi.T, dBP, cfg.axis)
        close = torch.abs(lam[:, None] - lam[None, :]) < cfg.eig_atol
        Cd = torch.where(close, -0.5 * dBG, 0.0)
        dPhi = psi + Phi @ Cd
    return lam, Phi, dlam, dPhi


class EighGenFwd(torch.autograd.Function):
    """``eigh_gen``'s primal with a forward-mode rule (``eigh_gen_fwdmode``).
    The forward solve reaches ``setup_context`` through ``box``, as in
    ``SolveSPD``; the ctx keeps it as ``_keep_solve`` does, the outputs
    saved as tensors, and the jvp rule runs ``eigh_gen_tangent`` on it."""

    @staticmethod
    def forward(problem, cfg, packed, box, *leaves):
        theta = leaves if packed else leaves[0]
        A, B = problem.assemble(theta)
        box.fwd = _forward_ops(theta, problem, A, B, cfg)
        res = box.fwd[2]
        return res.lam, res.Phi

    @staticmethod
    def setup_context(ctx, inputs, output):
        problem, cfg, packed, box, *leaves = inputs
        A, B, res, factor = box.fwd
        ctx.save_for_forward(*leaves, *output)
        ctx.solve = (A, B, dataclasses.replace(res, lam=None, Phi=None,
                                               BV=None), factor)
        ctx.problem, ctx.cfg, ctx.packed = problem, cfg, packed

    @staticmethod
    def jvp(ctx, _problem, _cfg, _packed, _box, *dleaves):
        leaves, fwd = _kept_solve(ctx)
        dleaves = [torch.zeros_like(t) if d is None else d
                   for t, d in zip(leaves, dleaves)]
        if ctx.packed:
            theta, dtheta = tuple(leaves), tuple(dleaves)
        else:
            theta, dtheta = leaves[0], dleaves[0]
        _, _, dlam, dPhi = eigh_gen_tangent(theta, dtheta, ctx.problem,
                                            ctx.cfg, fwd=fwd)
        return dlam, dPhi


def eigh_gen_fwdmode(theta, problem: EigProblem, cfg: EighGenConfig):
    """``eigh_gen`` with a forward-mode derivative rule, counterpart of
    ``eigd_tpu/ops/autodiff.py:358``: ``torch.func.jvp`` of any objective
    through it gives the exact directional derivative (the tangent of
    ``eigh_gen_tangent``, normal or buckling mode), the machine-precision
    oracle of the reverse-mode ``eigh_gen``, as the reference's
    complex-step channel is. The primal is ``eigh_gen``'s; there is no
    reverse rule. theta is a tensor or a tuple of tensors."""
    box = types.SimpleNamespace(fwd=None)
    if isinstance(theta, (tuple, list)):
        return EighGenFwd.apply(problem, cfg, True, box, *theta)
    return EighGenFwd.apply(problem, cfg, False, box, theta)


def kept_forward(out):
    """The forward solve ``(A, B, res, factor)`` that ``eigh_gen`` keeps
    for the backward pass of its output ``out`` (lam or Phi, with its
    graph), for ``eigh_gen_tangent(..., fwd=)``: a tangent on the very
    solve a reverse pass differentiates."""
    ctx = out.grad_fn
    if ctx is None or not hasattr(ctx, "solve"):
        raise ValueError("not an output of eigh_gen that holds its graph")
    return _kept_solve(ctx)[1]


def staged_jvp(pre, tail, problem: EigProblem, cfg: EighGenConfig):
    """Directional derivative of ``x -> tail(eigh_gen(pre(x)))`` by forward
    mode: the jvp-vs-vjp oracle of the 1M-DOF problem.

    Counterpart of ``eigd_tpu/ops/autodiff.py:496-540``. The forward
    eigensolve runs once and its (A, B, res, factor) feed the tangent
    solve; both modes share the primal solve, so |jvp - g.p| isolates
    solver and derivation error with no FD step. Returns
    ``fn(x, p) -> (value, dvalue)``. Its stages are spans
    (``staged_jvp.*``, ``eigh_gen_tangent.*``).
    """
    def fn(x, p):
        with torch.no_grad(), span("staged_jvp.forward"):
            theta = pre(x)
            A, B = problem.assemble(theta)
            fwd = _forward_ops(theta, problem, A, B, cfg)
        with span("staged_jvp.pre"):
            theta, dtheta = torch.func.jvp(pre, (x,), (p,))
        lam, Phi, dlam, dPhi = eigh_gen_tangent(theta, dtheta, problem, cfg,
                                                fwd=fwd)
        with span("staged_jvp.tail"):
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
    rules (simple eigenvalues only): the gradient oracle of the tests.

    mode="buckling": (A, B) = (G, K); returns the eigenvalues mu of
    G phi = mu K phi (the load factors are -1/mu) and the K-orthonormal
    vectors, ordered by -1/mu as JAX's oracle returns them."""
    L, w, y = _cholesky_pencil(A, B)
    if mode == "buckling":
        order = torch.argsort(-1.0 / w, stable=True)[:N]
        w, y = w[order], y[:, order]
    elif mode == "normal":
        w, y = w[:N], y[:, :N]
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    phi = torch.linalg.solve_triangular(L.T, y, upper=True)
    return w, phi


def eigh_gen_directional_oracle(A, B, dA, dB, N, eig_atol=1e-5,
                                mode="normal"):
    """Directional derivative of the N smallest eigenpairs along (dA, dB),
    with the reference's complex-step semantics: the coupling of a
    numerically repeated pair (|lam_j - lam_i| <= eig_atol) keeps only its
    symmetric part -1/2 phi_j^T dB phi_i, as on the diagonal.

    mode="buckling": (A, B) = (G, K), lam = -1/mu the load factors of
    G phi = mu K phi in ascending mu; W_i = (dB + lam_i dA) phi_i,
    dlam_i = lam_i phi_i^T W_i and the distinct couplings
    -lam_j phi_j^T W_i / (lam_j - lam_i).

    Returns (lam, Phi, dlam, dPhi) for the N selected modes.
    """
    with torch.no_grad():
        L, mu, y = _cholesky_pencil(A, B)
        Phi = torch.linalg.solve_triangular(L.T, y, upper=True)
        P = Phi[:, :N]
        if mode == "buckling":
            lam = -1.0 / mu
            W = dB @ P + (dA @ P) * lam[None, :N]
            dlam = lam[:N] * torch.sum(P * W, dim=0)
            diff = lam[:, None] - lam[None, :N]  # [j, i] = lam_j - lam_i
            coef = -lam[:, None] * (Phi.T @ W)
        elif mode == "normal":
            lam = mu
            W = dA @ P - (dB @ P) * lam[None, :N]  # (dA - lam_i dB) phi_i
            dlam = torch.sum(P * W, dim=0)
            diff = lam[None, :N] - lam[:, None]  # [j, i] = lam_i - lam_j
            coef = Phi.T @ W
        else:
            raise ValueError(f"Unknown mode {mode!r}")
        far = torch.abs(diff) > eig_atol
        C = torch.where(far, coef / torch.where(far, diff, 1.0),
                        -0.5 * (Phi.T @ (dB @ P)))
        return lam[:N], P, dlam, Phi @ C
