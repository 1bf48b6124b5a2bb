"""Wingbox modal analysis with per-component shell thickness design
variables: the CRM family.

Counterpart of ``eigd_tpu/models/crm.py`` and of the reference's CRM
example: a parametric swept, tapered wingbox (skins, spars, ribs) meshed
in flat-shell quads, or a NASTRAN BDF (``CRM.from_bdf``, the subset of
``fem/bdf.py``); K(t), M(t) assembled as batched einsums, differentiable in
the per-component thicknesses; the modal analysis, modal compliance and
its adjoint total derivative.

Two factorization paths:

* dense (factor_kind "cholesky"): matrices reduced to the free DOFs, the
  small-problem oracle.
* scalable ("bcr_f32", the default, "bcr", "blocktridiag[_f32]"): the
  nodes group into span stations that couple only to adjacent ones, so
  with a station-padded DOF layout the shifted matrix is block
  tridiagonal. The operators stay element operators (gather, ``bmm``,
  scatter-add), Dirichlet and padding DOFs are masked (zero rows and
  columns), and nothing is densified. The "_f32" kinds factor the
  equilibrated, jittered matrix in f32 and solve by f64 PCG on it
  (``PCGFactor``); the others factor it in f64.

The three-phase protocol holds the autograd graph of ``_solve_fn(x)``
(JAX holds its staged programs' residuals), so ``finalize_adjoint`` may
run any number of times on one solve, and ``objective_jvp`` runs the
forward-mode tangent on that same kept forward solve.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..fem.shell import shell_element_matrices
from ..ops.autodiff import (EigProblem, EighGenConfig, eigh_gen,
                            eigh_gen_tangent, kept_forward)
from ..ops.operators import (DenseOperator, ElementOperator, element_dense,
                             scatter_rows)
from ..ops.sync import span
from .natural_frequency import weakly

FACTOR_KINDS = ("cholesky", "bcr", "bcr_f32", "blocktridiag",
                "blocktridiag_f32")


def balance_node_blocks(station, conn, nb, passes=6):
    """Rebalance the node -> block map to cut station padding.

    The block-tridiagonal factor pads every block to the largest station,
    and BCR costs nb * b^3: on the wingbox the rib stations (skin ring and
    rib interior) are about 2.5x the others. Any assignment in which mesh-
    coupled nodes sit in the same or adjacent blocks is exactly block
    tridiagonal, and rib-interior nodes couple only within their station,
    so they may spill into lighter neighbours.

    Each pass moves nodes in one direction d only: a node at block s may
    move to s + d only if every mesh partner sits at a block >= s (d = +1)
    or <= s (d = -1), which keeps every element within two adjacent blocks
    under bulk moves. Quotas (counts[s] - counts[s + d]) // 2 diffuse the
    imbalance; the best layout seen is returned, never worse than the raw
    station map. numpy, bitwise JAX's.
    """
    conn = np.asarray(conn)
    nnodes = station.shape[0]
    blocks = station.astype(np.int64).copy()
    k = conn.shape[1]
    src = np.repeat(conn, k, axis=1).reshape(-1)
    dst = np.tile(conn, (1, k)).reshape(-1)

    best = blocks.copy()
    best_max = int(np.bincount(blocks, minlength=nb).max())
    for _ in range(passes):
        moved = 0
        for d in (+1, -1):
            nbr_min = np.full(nnodes, nb, dtype=np.int64)
            nbr_max = np.full(nnodes, -1, dtype=np.int64)
            np.minimum.at(nbr_min, src, blocks[dst])
            np.maximum.at(nbr_max, src, blocks[dst])
            counts = np.bincount(blocks, minlength=nb)
            if d == +1:
                eligible = (nbr_min >= blocks) & (blocks + 1 < nb)
            else:
                eligible = (nbr_max <= blocks) & (blocks - 1 >= 0)
            s_ids = np.arange(nb)
            t_ids = np.clip(s_ids + d, 0, nb - 1)
            quota = np.maximum((counts[s_ids] - counts[t_ids]) // 2, 0)
            idx = np.nonzero(eligible)[0]
            if idx.size == 0:
                continue
            idx = idx[np.argsort(blocks[idx], kind="stable")]
            b_el = blocks[idx]
            start = np.searchsorted(b_el, np.arange(nb))
            rank = np.arange(idx.size) - start[b_el]
            sel = idx[rank < quota[b_el]]
            if sel.size:
                blocks[sel] += d
                moved += int(sel.size)
        cur_max = int(np.bincount(blocks, minlength=nb).max())
        if cur_max < best_max:
            best_max = cur_max
            best = blocks.copy()
        if moved == 0:
            break
    blocks = best
    # the block extraction drops out-of-band couplings silently, so the
    # adjacency is checked here
    be = blocks[conn]
    span = be.max(axis=1) - be.min(axis=1)
    if int(span.max()) > 1:
        bad = int(np.argmax(span))
        raise AssertionError(
            f"block balancing broke adjacency on element {conn[bad]}")
    return blocks


def make_wingbox_mesh(nspan=8, nchord=4, nheight=2, span=10.0, c_root=3.0,
                      c_tip=1.2, h_root=0.6, h_tip=0.25, sweep=0.3,
                      nribs=3):
    """Parametric wingbox: top and bottom skins, front and rear spars,
    evenly spaced ribs. Returns (X (nnodes, 3), conn (nelems, 4),
    comp (nelems,), names); numpy, bitwise JAX's."""
    key2node = {}
    X = []

    def node(x, y, z):
        key = (round(x, 9), round(y, 9), round(z, 9))
        if key not in key2node:
            key2node[key] = len(X)
            X.append([x, y, z])
        return key2node[key]

    def section(j):
        f = j / nspan
        c = c_root + (c_tip - c_root) * f
        h = h_root + (h_tip - h_root) * f
        xoff = sweep * span * f
        y = span * f
        return c, h, xoff, y

    conn = []
    comp = []
    names = ["top_skin", "bottom_skin", "front_spar", "rear_spar", "ribs"]

    def add_quad(n0, n1, n2, n3, cid):
        conn.append([n0, n1, n2, n3])
        comp.append(cid)

    # skins: a grid in (chord i, span j)
    def skin(zsign, cid):
        for j in range(nspan):
            c0, h0, x0, y0 = section(j)
            c1, h1, x1, y1 = section(j + 1)
            for i in range(nchord):
                fa, fb = i / nchord, (i + 1) / nchord
                a = node(x0 + (fa - 0.5) * c0, y0, zsign * h0 / 2)
                b = node(x0 + (fb - 0.5) * c0, y0, zsign * h0 / 2)
                d = node(x1 + (fb - 0.5) * c1, y1, zsign * h1 / 2)
                e = node(x1 + (fa - 0.5) * c1, y1, zsign * h1 / 2)
                add_quad(a, b, d, e, cid)

    skin(+1, 0)
    skin(-1, 1)

    # spars: a grid in (span j, height k) at chord fraction 0 / 1
    def spar(cfrac, cid):
        for j in range(nspan):
            c0, h0, x0, y0 = section(j)
            c1, h1, x1, y1 = section(j + 1)
            for k in range(nheight):
                ga, gb = k / nheight - 0.5, (k + 1) / nheight - 0.5
                a = node(x0 + (cfrac - 0.5) * c0, y0, ga * h0)
                b = node(x0 + (cfrac - 0.5) * c0, y0, gb * h0)
                d = node(x1 + (cfrac - 0.5) * c1, y1, gb * h1)
                e = node(x1 + (cfrac - 0.5) * c1, y1, ga * h1)
                add_quad(a, e, d, b, cid)

    spar(0.0, 2)
    spar(1.0, 3)

    # ribs: full cross-section sheets at evenly spaced interior stations
    rib_js = np.linspace(0, nspan, nribs + 2).astype(int)[1:-1]
    for j in rib_js:
        c0, h0, x0, y0 = section(int(j))
        for i in range(nchord):
            fa, fb = i / nchord, (i + 1) / nchord
            for k in range(nheight):
                ga, gb = k / nheight - 0.5, (k + 1) / nheight - 0.5
                a = node(x0 + (fa - 0.5) * c0, y0, ga * h0)
                b = node(x0 + (fb - 0.5) * c0, y0, ga * h0)
                d = node(x0 + (fb - 0.5) * c0, y0, gb * h0)
                e = node(x0 + (fa - 0.5) * c0, y0, gb * h0)
                add_quad(a, b, d, e, 4)

    return (np.array(X), np.array(conn, dtype=np.int32),
            np.array(comp, dtype=np.int32), names)


def station_layout(block_of_node, station_of_node, conn, nb):
    """The station-padded DOF layout: (b, node_dof0, dofs, free_mask).

    Nodes of a block take consecutive slots in node order, b is 6x the
    largest block, node_dof0 the first DOF of each node, dofs the
    (nelems, 24) element DOF map and free_mask 1.0 on the DOFs of nodes
    off station 0 (the clamped root; padding stays 0). numpy; the ranks
    come from a stable sort in place of JAX's loop over nodes, the same
    integers."""
    nnodes = block_of_node.shape[0]
    counts = np.bincount(block_of_node, minlength=nb)
    b = 6 * int(counts.max())
    order = np.argsort(block_of_node, kind="stable")
    start = np.cumsum(counts) - counts
    rank = np.empty(nnodes, dtype=np.int64)
    rank[order] = np.arange(nnodes) - start[block_of_node[order]]
    node_dof0 = block_of_node * b + 6 * rank
    dofs = (node_dof0[np.asarray(conn)][:, :, None]
            + np.arange(6)).reshape(-1, 24)
    free_mask = np.zeros(nb * b)
    free_nodes = node_dof0[station_of_node != 0]
    free_mask[(free_nodes[:, None] + np.arange(6)).reshape(-1)] = 1.0
    return b, node_dof0, dofs, free_mask


class CRM:
    """Wingbox modal analysis (the reference's CRM class surface)."""

    def __init__(self, nspan=48, nchord=8, nheight=3, N=6, m=None, sigma=0.0,
                 E=70e9, nu=0.3, rho=2700.0, t0=0.01, omega0=None,
                 adjoint_method="sibk", rtol=1e-10, eig_atol=1e-5,
                 factor_kind="bcr_f32", nribs=None, lanczos_polish=None,
                 lanczos_polish_spare=0, lanczos_block=None,
                 lanczos_ortho="full", lanczos_sweep=None,
                 factor_jitter=1e-4, factor_tol=1e-12, factor_maxiter=200,
                 approx_tol=1e-8, approx_maxiter=80, adjoint_maxiter=60,
                 device="cuda", _mesh=None, **mesh_kw):
        del omega0  # JAX's signature; sigma 0 is valid for the clamped box
        self.device = torch.device(device)
        if _mesh is not None:
            # an ingested mesh (from_bdf, interop): geometry, components
            # and the station map come prebuilt
            X = np.array(_mesh["X"], dtype=np.float64)
            conn = np.array(_mesh["conn"], dtype=np.int32)
            comp = np.array(_mesh["comp"], dtype=np.int32)
            names = list(_mesh["names"])
        else:
            if nribs is None:
                nribs = max(3, nspan // 8)
            X, conn, comp, names = make_wingbox_mesh(nspan, nchord, nheight,
                                                     nribs=nribs, **mesh_kw)
        if factor_kind not in FACTOR_KINDS:
            raise ValueError(
                f"Unknown factor_kind {factor_kind!r}; expected 'cholesky' "
                "(dense small-problem oracle) or one of the scalable "
                "block-tridiagonal kinds 'bcr[_f32]'/'blocktridiag[_f32]'.")
        dev = self.device
        self.X = torch.as_tensor(X, dtype=torch.float64, device=dev)
        self.conn = torch.as_tensor(conn, dtype=torch.int64, device=dev)
        self.comp = torch.as_tensor(comp, dtype=torch.int64, device=dev)
        self.component_names = names
        self.ncomp = len(names)
        self.nnodes = X.shape[0]
        self.E, self.nu, self.rho = E, nu, rho
        self.N = N
        self.factor_kind = factor_kind
        self.factor_jitter = factor_jitter
        self.factor_tol = factor_tol
        self.factor_maxiter = factor_maxiter
        self.approx_tol = approx_tol
        self.approx_maxiter = approx_maxiter
        self.scalable = factor_kind != "cholesky"

        # station-padded layout: the parametric wingbox's nodes sit on span
        # stations y = span j / nspan; an ingested mesh brings a BFS level
        # map (fem.bdf.bfs_levels). Either couples adjacent stations only.
        if _mesh is not None:
            station_of_node = np.asarray(_mesh["station"], dtype=np.int64)
            self.nb = int(station_of_node.max()) + 1
        else:
            ys = np.unique(np.round(X[:, 1], 9))
            station_of_node = np.searchsorted(ys, np.round(X[:, 1], 9))
            self.nb = len(ys)
        block_of_node = balance_node_blocks(station_of_node, conn, self.nb)
        self.b, node_dof0, dofs, free_mask = station_layout(
            block_of_node, station_of_node, conn, self.nb)
        self.b_nodes = self.b // 6
        self.nvars = self.nb * self.b
        self.station_of_node = station_of_node
        self.node_dof0 = torch.as_tensor(node_dof0, device=dev)
        self.dofs = torch.as_tensor(dofs, device=dev)
        self.free_mask = torch.as_tensor(free_mask, device=dev)
        self.free = torch.as_tensor(np.nonzero(free_mask)[0], device=dev)

        # JAX's defaults (eigd_tpu/models/crm.py): the block sweep at
        # padded nvars >= 60,000, m by the block-Krylov degree, and at that
        # scale the approx sweep with 3 polish steps
        if lanczos_block is None:
            lanczos_block = 8 if self.nvars >= 60_000 else 1
        if m is None:
            m = (max(3 * N + 1, 60) if lanczos_block == 1
                 else lanczos_block * (2 * N + 8))
        self.m = m
        at_scale = (self.scalable and lanczos_block > 1
                    and self.nvars >= 60_000)
        if lanczos_sweep is None:
            lanczos_sweep = "approx" if at_scale else "exact"
        if lanczos_polish is None:
            lanczos_polish = 0 if lanczos_sweep == "exact" else 3

        # design variables: a thickness per component (the PSHELL values
        # of an ingested deck)
        if _mesh is not None and _mesh.get("thickness") is not None:
            self.x = torch.as_tensor(np.asarray(_mesh["thickness"],
                                                dtype=np.float64), device=dev)
        else:
            self.x = torch.full((self.ncomp,), t0, dtype=torch.float64,
                                device=dev)

        # the mixed SIBK ladder: each step a truncated f32 PCG
        # (factor.approx_mv), the rounds restarting on f64 residuals
        mixed = self.scalable and adjoint_method in ("sibk", "pcpg")
        self.cfg = EighGenConfig(
            N=N, m=m, sigma=float(0.0 if sigma is None else sigma),
            mode="normal", adjoint_method=adjoint_method,
            adjoint_maxiter=adjoint_maxiter, adjoint_rtol=rtol * 1e-2,
            nrestart=12 if mixed else 2, adjoint_mixed=mixed,
            eig_atol=eig_atol, polish=lanczos_polish,
            polish_spare=int(lanczos_polish_spare), block=lanczos_block,
            lanczos_ortho=lanczos_ortho, lanczos_sweep=lanczos_sweep)
        if self.scalable:
            self.problem = EigProblem(assemble=weakly(self._assemble),
                                      factor=weakly(self._factor),
                                      v0=weakly(self._v0))
        else:
            self.problem = EigProblem(assemble=weakly(self._assemble))
        self.lam = self.Qr = self.Q = None
        self._graph = None
        self.profile: Dict = {"nnodes": self.nnodes, "nvars": self.nvars,
                              "nelems": int(conn.shape[0]), "N": N, "m": m,
                              "stations": self.nb, "block": self.b,
                              "factor_kind": factor_kind}

    @classmethod
    def from_bdf(cls, path, N=6, **kw):
        """The model of a NASTRAN bulk-data file (GRID / CQUAD4 / PSHELL /
        MAT1 / SPC(1), ``fem/bdf.py``). The station map is the BFS level
        structure rooted at the constrained nodes (level 0 is the clamp);
        one thickness design variable per PSHELL, from its T field."""
        from ..fem.bdf import bfs_levels, parse_bdf

        mdl = parse_bdf(path)
        if mdl.spc_nodes.size == 0:
            raise ValueError(
                "BDF has no SPC/SPC1 constraints; the modal pipeline "
                "clamps station 0 and needs at least one constrained node")
        levels, _ = bfs_levels(mdl.conn, mdl.X.shape[0], mdl.spc_nodes)
        mesh = {"X": mdl.X, "conn": mdl.conn, "comp": mdl.comp,
                "names": mdl.component_names, "station": levels,
                "thickness": mdl.thickness}
        return cls(N=N, E=mdl.E, nu=mdl.nu, rho=mdl.rho, _mesh=mesh, **kw)

    # -- differentiable assembly -------------------------------------------

    def _element_mats(self, tcomp):
        Ke, Me = shell_element_matrices(self.X[self.conn], tcomp[self.comp],
                                        E=self.E, nu=self.nu, rho=self.rho)
        me = self.free_mask[self.dofs]
        mm = me[:, :, None] * me[:, None, :]
        return Ke * mm, Me * mm

    def _assemble(self, tcomp):
        Ke, Me = self._element_mats(tcomp)
        if self.scalable:
            return (ElementOperator(Ke, self.dofs, self.nvars),
                    ElementOperator(Me, self.dofs, self.nvars))

        def reduced(mats):
            dense = element_dense(mats, self.dofs, self.nvars)
            return DenseOperator(dense[self.free[:, None],
                                       self.free[None, :]])

        return reduced(Ke), reduced(Me)

    def _factor(self, A, B, sig, mode):
        """The block-tridiagonal factor of A - sig B on the station layout.

        The "_f32" kinds: cond(K) of a thin shell passes 1/eps_f32, where
        an unscaled f32 Cholesky fails and refinement diverges. So the
        matrix is equilibrated, S A S with S = diag(A)^(-1/2) (rotation and
        membrane DOF scales differ by about 1/t^2), factored in f32 with a
        relative diagonal jitter (a Manteuffel shift; BCR only) that keeps
        the reduced blocks definite, and solved by f64 PCG on it, which
        needs only an SPD preconditioner. The blocks are assembled in f32
        directly; the element matrices stay f64 for the residuals."""
        from ..ops.blockfactor import (BCRFactor, BlockTridiagFactor,
                                       PCGFactor,
                                       block_tridiag_from_dof_groups)

        del mode
        shifted = A.mats - sig * B.mats
        cls_ = (BCRFactor if self.factor_kind.startswith("bcr")
                else BlockTridiagFactor)
        if not self.factor_kind.endswith("_f32"):
            blocks = list(block_tridiag_from_dof_groups(
                shifted, self.dofs, None, self.nb, self.b))
            del shifted
            return cls_.from_owned_blocks(blocks)
        dd = torch.diagonal(shifted, dim1=1, dim2=2)
        diag = scatter_rows(dd.reshape(-1), self.dofs.reshape(-1),
                            self.nvars)
        s = 1.0 / torch.sqrt(torch.where(diag <= 0.0, 1.0, diag))
        se = s[self.dofs]
        scaled = (shifted * se[:, :, None] * se[:, None, :]).to(
            torch.float32)
        blocks = list(block_tridiag_from_dof_groups(scaled, self.dofs, None,
                                                    self.nb, self.b))
        del scaled
        if cls_ is BCRFactor:
            inner = cls_.from_owned_blocks(blocks, jitter=self.factor_jitter)
        else:  # the block Cholesky takes no jitter
            inner = cls_.from_owned_blocks(blocks)
        op = ElementOperator(shifted, self.dofs, self.nvars)
        return PCGFactor(inner, op, s, mask=self.free_mask,
                         tol=self.factor_tol, maxiter=self.factor_maxiter,
                         approx_tol=self.approx_tol,
                         approx_maxiter=self.approx_maxiter)

    def _v0(self, theta):
        """A uniform start vector on [-1, 1) from a seeded
        ``torch.Generator``, zero on the masked DOFs (JAX draws its own
        from ``jax.random``: parity tests pass it through interop)."""
        g = torch.Generator().manual_seed(12345)
        v = 2.0 * torch.rand(self.nvars, generator=g,
                             dtype=torch.float64) - 1.0
        return v.to(self.device) * self.free_mask

    def _solve_fn(self, tcomp):
        return eigh_gen(tcomp, self.problem, self.cfg)

    # -- three-phase protocol ----------------------------------------------

    def _elapsed(self, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @span("eigd.protocol.initialize")
    def initialize(self, store=False):
        """Solve at ``self.x`` and hold the autograd graph of the solve for
        ``finalize_adjoint`` and ``objective_jvp``, releasing the previous
        one first."""
        t0 = time.perf_counter()
        self._graph = None
        x = self.x.detach().requires_grad_(True)
        with torch.enable_grad():
            lam, Qr = self._solve_fn(x)
        self._graph = (x, lam, Qr)
        self.lam, self.Qr = lam.detach(), Qr.detach()
        if self.scalable:
            self.Q = self.Qr  # already the full (padded) space
        else:
            self.Q = self.Qr.new_zeros((self.nvars, self.N)).index_put(
                (self.free,), self.Qr)
        self.profile["eigenvalue solve time"] = self._elapsed(t0)
        self.profile["natural frequencies (Hz)"] = (
            torch.sqrt(self.lam) / (2 * np.pi)).tolist()
        if store:
            self.profile["eigenvalues"] = self.lam.tolist()

    def initialize_adjoint(self):
        self.xb = torch.zeros_like(self.x)
        self.lamb = torch.zeros_like(self.lam)
        self.Qrb = torch.zeros_like(self.Qr)

    @span("eigd.protocol.finalize_adjoint")
    def finalize_adjoint(self):
        """xb += the seeds (lamb, Qrb) pulled through the held graph, which
        stays for further passes until the next ``initialize``."""
        t0 = time.perf_counter()
        x, lam, Qr = self._graph
        (xb,) = torch.autograd.grad((lam, Qr), x, (self.lamb, self.Qrb),
                                    retain_graph=True)
        self.xb = self.xb + xb
        self.profile["adjoint solution time"] = self._elapsed(t0)

    def objective_jvp(self, p):
        """Forward-mode directional derivative of the seeded objective
        along the thickness direction ``p``: lamb . dlam + <Qrb, dQr>, by
        ``eigh_gen_tangent`` on the forward solve the held graph kept. It
        shares the primal solve with ``finalize_adjoint``, so its gap to
        ``p @ xb`` is solver and derivation error, with no FD step (the
        role of the reference's complex-step check). Needs the seeds
        (``initialize_adjoint`` and ``add_*_derivative``)."""
        t0 = time.perf_counter()
        x, lam, _ = self._graph
        p = torch.as_tensor(np.asarray(p), dtype=x.dtype, device=x.device)
        _, _, dlam, dQr = eigh_gen_tangent(x.detach(), p, self.problem,
                                           self.cfg, fwd=kept_forward(lam))
        out = float(torch.sum(self.lamb * dlam) + torch.sum(self.Qrb * dQr))
        self.profile["tangent solution time"] = self._elapsed(t0)
        return out

    # -- modal compliance ----------------------------------------------------

    def tip_load(self):
        """A unit vertical load spread over the tip section's nodes, in the
        padded layout."""
        Xn = self.X.cpu().numpy()
        tip_nodes = np.nonzero(Xn[:, 1] > Xn[:, 1].max() - 1e-9)[0]
        f = np.zeros(self.nvars)
        f[self.node_dof0.cpu().numpy()[tip_nodes] + 2] = 1.0 / len(tip_nodes)
        return torch.as_tensor(f, device=self.device)

    def _reduced_f(self, f):
        return f if self.scalable else f[self.free]

    def get_modal_compliance(self, f=None):
        fr = self._reduced_f(self.tip_load() if f is None else f)
        vals = self.Qr.T @ fr
        return torch.sum(vals**2 / self.lam)

    def add_modal_compliance_derivative(self, scale=1.0, f=None):
        """lamb, Qrb += scale * the gradient of sum (Qr^T f)^2 / lam."""
        fr = self._reduced_f(self.tip_load() if f is None else f)
        vals = self.Qr.T @ fr
        self.lamb = self.lamb - scale * vals**2 / self.lam**2
        self.Qrb = self.Qrb + scale * 2.0 * torch.outer(fr, vals / self.lam)

    def node_displacements(self, mode):
        """(nnodes, 3) translational components of eigenvector ``mode``
        (numpy)."""
        Q = self.Q[:, mode].cpu().numpy()
        nd0 = self.node_dof0.cpu().numpy()
        return np.stack([Q[nd0 + d] for d in range(3)], axis=1)

    def write_modes(self, prefix="crm_mode", nmodes=None, scale=0.4):
        """Mode-shape PNGs ``<prefix><mode>.png`` (3D wireframes of the
        displaced box, ``utils.plot.plot_shell_mode``), the role of the
        reference's TACS .f5 output. Returns the paths written: none
        without matplotlib."""
        from ..utils.plot import plot_shell_mode

        nmodes = self.N if nmodes is None else nmodes
        Xn = self.X.cpu().numpy()
        paths = []
        for mode in range(nmodes):
            U = self.node_displacements(mode)
            amp = scale * np.abs(Xn).max() / max(np.abs(U).max(), 1e-30)
            fhz = float(torch.sqrt(self.lam[mode]) / (2 * np.pi))
            path = plot_shell_mode(Xn, self.conn, amp * U,
                                   f"mode {mode}: {fhz:.2f} Hz",
                                   f"{prefix}{mode}.png")
            if path is None:
                break
            paths.append(path)
        return paths
