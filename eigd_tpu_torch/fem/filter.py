"""Topology-optimization density filter on a uniform grid.

Counterpart of ``eigd_tpu/fem/filter.py:81-189`` for ``ftype="conv"``: the
(r0 - d) spatial filter on a regular grid is a fixed small kernel plus a
per-node normalization, applied as an f64 ``conv2d``. Like JAX's
``conv_general_dilated``, ``conv2d`` is a cross-correlation, so the kernel
is used as it is (it is symmetric in any case). Optional design-variable
maps with frozen (-1) entries and the tanh projection are included; the
transpose comes from ``torch.autograd``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class NodeFilter:
    """Density filter with the surface of ``eigd_tpu.fem.filter.NodeFilter``
    (conv type only)."""

    def __init__(self, conn, X, r0=1.0, ftype="conv", dvmap=None,
                 num_design_vars=None, beta=10.0, eta=0.5, projection=False,
                 grid_shape=None, device="cuda"):
        if ftype != "conv":
            raise NotImplementedError(
                f"ftype={ftype!r}: only the uniform-grid 'conv' filter is "
                "ported (ROADMAP queue 1, item 2 lists 'spatial' and "
                "'helmholtz')")
        if grid_shape is None:
            raise ValueError("ftype='conv' needs grid_shape")
        self.conn = np.asarray(conn)
        self.X = np.asarray(X)
        self.nnodes = int(self.conn.max()) + 1
        self.ftype = ftype
        self.r0 = r0
        self.beta = beta
        self.eta = eta
        self.projection = projection
        self.grid_shape = tuple(grid_shape)
        self.device = torch.device(device)

        if dvmap is not None and num_design_vars is not None:
            self.dvmap = torch.as_tensor(np.array(dvmap), device=device)
            self.num_design_vars = num_design_vars
        else:
            self.dvmap = None
            self.num_design_vars = self.nnodes

        gnx, gny = self.grid_shape
        hx = (self.X[:, 0].max() - self.X[:, 0].min()) / gnx
        hy = (self.X[:, 1].max() - self.X[:, 1].min()) / gny
        rx = int(np.floor(r0 / hx))
        ry = int(np.floor(r0 / hy))
        dx = np.arange(-rx, rx + 1) * hx
        dy = np.arange(-ry, ry + 1) * hy
        d = np.sqrt(dx[:, None] ** 2 + dy[None, :] ** 2)
        self._kernel = torch.as_tensor(np.maximum(r0 - d, 0.0),
                                       dtype=torch.float64, device=device)

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
        rho = self._conv_apply(xn)
        if self.projection:
            beta, eta = self.beta, self.eta
            denom = np.tanh(beta * eta) + np.tanh(beta * (1.0 - eta))
            rho = (np.tanh(beta * eta)
                   + torch.tanh(beta * (rho - eta))) / denom
        return rho
