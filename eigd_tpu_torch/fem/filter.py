"""Topology-optimization density filters.

Counterpart of ``eigd_tpu/fem/filter.py``, all three types:

* ``"conv"``: the (r0 - d) spatial filter on a uniform grid as a fixed
  small kernel plus a per-node normalization, applied as an f64
  ``conv2d``. Like JAX's ``conv_general_dilated``, ``conv2d`` is a
  cross-correlation, so the kernel is used as it is (it is symmetric in
  any case).
* ``"spatial"``: the same filter on any mesh, as a padded-ELL gather
  (``kmax`` neighbours a node, weight-0 padding) built once on the host
  with scipy's ``KDTree``. JAX may build its ELL with its native search
  instead; the neighbours and weights are the same, so the filtered field
  agrees to rounding.
* ``"helmholtz"``: rho = A^{-1} B x with A = C + r0^2 int grad^T grad and
  B = int H H^T assembled densely from the scalar Q4 tables and A held as
  a ``CholeskyFactor``.

Optional design-variable maps with frozen (-1) entries and the tanh
projection are included; ``apply_gradient``, the transpose, comes from
``torch.autograd``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.factor import CholeskyFactor
from ..ops.operators import element_dense
from .quad import thermal_tables


def _spatial_weights(X, r0, kmax=None):
    """Host-side neighbour search -> padded ELL (idx, wts) numpy arrays:
    the weight of neighbour j of node i is (r0 - d_ij) / sum_j. The search
    is scipy's ``KDTree`` in parallel over nodes (``query`` with k = the
    largest neighbour count and a distance bound), with no Python loop
    over nodes; neighbours come nearest first."""
    from scipy import spatial

    tree = spatial.KDTree(X)
    counts = tree.query_ball_point(X, r0, return_length=True, workers=-1)
    if kmax is None:
        kmax = int(counts.max())
    elif kmax < counts.max():
        raise ValueError(f"kmax={kmax} is below the largest neighbour count "
                         f"{int(counts.max())}")
    d, idx = tree.query(X, k=kmax, distance_upper_bound=np.nextafter(
        r0, np.inf), workers=-1)
    d, idx = d.reshape(len(X), kmax), idx.reshape(len(X), kmax)
    keep = d <= r0
    w = np.where(keep, r0 - np.where(keep, d, r0), 0.0)
    return np.where(keep, idx, 0).astype(np.int64), w / w.sum(
        axis=1, keepdims=True)


def _helmholtz_matrices(X, conn, r0):
    """The dense Helmholtz filter matrices A and B (nnodes, nnodes)."""
    Be, He, detJ = thermal_tables(X, conn)
    Ce = torch.einsum("qe,qei,qej->eij", detJ, He, He)
    Ae = Ce + r0**2 * torch.einsum("qe,qeki,qekj->eij", detJ, Be, Be)
    n = X.shape[0]
    return element_dense(Ae, conn, n), element_dense(Ce, conn, n)


class NodeFilter:
    """Density filter with the surface of ``eigd_tpu.fem.filter.NodeFilter``.

    State by type: ``_kernel`` (conv), ``idx``/``wts`` (spatial),
    ``_chol``/``_Bmat`` (helmholtz); ``interop.filter_from_numpy`` sets
    them from JAX's arrays.
    """

    def __init__(self, conn, X, r0=1.0, ftype="spatial", dvmap=None,
                 num_design_vars=None, beta=10.0, eta=0.5, projection=False,
                 kmax=None, grid_shape=None, device="cuda"):
        self.conn = np.asarray(conn)
        self.X = np.asarray(X)
        self.nnodes = int(self.conn.max()) + 1
        self.ftype = ftype
        self.r0 = r0
        self.beta = beta
        self.eta = eta
        self.projection = projection
        self.grid_shape = (tuple(grid_shape) if grid_shape is not None
                           else None)
        self.device = torch.device(device)

        if dvmap is not None and num_design_vars is not None:
            self.dvmap = torch.as_tensor(np.array(dvmap), device=device)
            self.num_design_vars = num_design_vars
        else:
            self.dvmap = None
            self.num_design_vars = self.nnodes

        self._kernel = self.idx = self.wts = self._chol = self._Bmat = None
        if ftype == "conv":
            if self.grid_shape is None:
                raise ValueError("ftype='conv' needs grid_shape")
            gnx, gny = self.grid_shape
            hx = (self.X[:, 0].max() - self.X[:, 0].min()) / gnx
            hy = (self.X[:, 1].max() - self.X[:, 1].min()) / gny
            rx = int(np.floor(r0 / hx))
            ry = int(np.floor(r0 / hy))
            dx = np.arange(-rx, rx + 1) * hx
            dy = np.arange(-ry, ry + 1) * hy
            d = np.sqrt(dx[:, None] ** 2 + dy[None, :] ** 2)
            self._kernel = torch.as_tensor(np.maximum(r0 - d, 0.0),
                                           dtype=torch.float64,
                                           device=device)
        elif ftype == "spatial":
            idx, wts = _spatial_weights(self.X, r0, kmax=kmax)
            self.idx = torch.as_tensor(idx, device=device)
            self.wts = torch.as_tensor(wts, device=device)
        elif ftype == "helmholtz":
            A, Bmat = _helmholtz_matrices(
                torch.as_tensor(np.array(self.X), dtype=torch.float64,
                                device=device),
                torch.as_tensor(np.array(self.conn), dtype=torch.int64,
                                device=device),
                r0)
            self._chol = CholeskyFactor.from_matrix(A)
            self._Bmat = Bmat
        else:
            raise ValueError(f"Unknown filter type {ftype!r}")

    def _conv_apply(self, xn):
        gnx, gny = self.grid_shape
        xg = xn.reshape(gnx + 1, gny + 1)
        ker = self._kernel
        kx, ky = ker.shape

        def conv(img):
            return F.conv2d(img[None, None], ker[None, None],
                            padding=(kx // 2, ky // 2))[0, 0]

        num = conv(xg)
        den = conv(torch.ones_like(xg))
        return (num / den).reshape(-1)

    def apply(self, x):
        """x (design vars) -> rho (nodal densities)."""
        if self.dvmap is not None:
            safe = torch.clamp(self.dvmap, min=0)
            xn = torch.where(self.dvmap <= -1, torch.ones_like(x[safe]),
                             x[safe])
        else:
            xn = x
        if self.ftype == "spatial":
            rho = torch.sum(self.wts * xn[self.idx], dim=1)
        elif self.ftype == "conv":
            rho = self._conv_apply(xn)
        else:
            rho = self._chol.mv(self._Bmat @ xn)
        if self.projection:
            beta, eta = self.beta, self.eta
            denom = np.tanh(beta * eta) + np.tanh(beta * (1.0 - eta))
            rho = (np.tanh(beta * eta)
                   + torch.tanh(beta * (rho - eta))) / denom
        return rho

    def apply_gradient(self, g, x=None, rho=None):
        """Chain a nodal cotangent g back to the design variables: the
        exact transpose of ``apply`` at x (default all ones), by
        ``torch.autograd``."""
        del rho
        if x is None:
            x = torch.ones(self.num_design_vars, dtype=torch.float64,
                           device=self.device)
        with torch.enable_grad():
            x = torch.as_tensor(x, device=self.device).detach()
            x.requires_grad_(True)
            (gx,) = torch.autograd.grad(
                self.apply(x), x, torch.as_tensor(g, device=self.device))
        return gx
