"""Structured-grid mesh factories for the example problems.

Host-side setup code (runs once, plain numpy): node coordinates, element
connectivity, symmetry design-variable maps, node/element sets and the
cantilever boundary of buckling. A copy
of ``eigd_tpu/fem/model.py``: importing that module would import JAX
through the ``eigd_tpu`` package, and this package never does. The outputs
are numpy arrays that the torch compute path moves to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class GridMesh:
    nx: int
    ny: int
    Lx: float
    Ly: float
    conn: np.ndarray  # (nelems, 4) int32
    X: np.ndarray  # (nnodes, 2) float64
    nodes: np.ndarray  # (nx+1, ny+1) node index grid

    @property
    def nelems(self):
        return self.conn.shape[0]

    @property
    def nnodes(self):
        return self.X.shape[0]


def make_grid(nx, ny, Lx=1.0, Ly=1.0):
    """Regular quad grid; element (i + nx*j) has nodes
    [n(i,j), n(i+1,j), n(i+1,j+1), n(i,j+1)] (counter-clockwise)."""
    x = np.linspace(0.0, Lx, nx + 1)
    y = np.linspace(0.0, Ly, ny + 1)
    nodes = np.arange((nx + 1) * (ny + 1), dtype=np.int32).reshape(
        nx + 1, ny + 1)

    X = np.zeros(((nx + 1) * (ny + 1), 2))
    xv, yv = np.meshgrid(x, y, indexing="ij")
    X[:, 0] = xv.reshape(-1)
    X[:, 1] = yv.reshape(-1)

    conn = np.zeros((nx * ny, 4), dtype=np.int32)
    i = np.arange(nx)
    j = np.arange(ny)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    e = (ii + nx * jj).reshape(-1)
    conn[e, 0] = nodes[ii, jj].reshape(-1)
    conn[e, 1] = nodes[ii + 1, jj].reshape(-1)
    conn[e, 2] = nodes[ii + 1, jj + 1].reshape(-1)
    conn[e, 3] = nodes[ii, jj + 1].reshape(-1)

    return GridMesh(nx=nx, ny=ny, Lx=Lx, Ly=Ly, conn=conn, X=X, nodes=nodes)


def make_symmetric_dvmap_with_sets(mesh: GridMesh, Mx=3, My=3, ns=2,
                                   rfact=4.0):
    """Symmetric design-variable map plus mass node/element sets.

    Rebuild of the set/dvmap construction in natural_frequency.make_model
    (:895-975): a (Mx x My) grid of point-mass node sets (frozen at density 1,
    dvmap entry -1), and quarter-symmetry mapping of the remaining nodes onto
    a reduced design vector.
    """
    nx, ny = mesh.nx, mesh.ny
    nodes = mesh.nodes
    dvmap = np.zeros((nx + 1, ny + 1), dtype=np.int64)

    node_sets: Dict[str, np.ndarray] = {}
    element_sets: Dict[str, np.ndarray] = {}

    ns = max(int(ns * ny // 32), int(rfact // 2))
    sx = nx // (Mx - 1)
    sy = ny // (My - 1)

    for i in range(Mx):
        for j in range(My):
            name = f"node[{i},{j}]"
            node_set = []
            element_set = []

            if i < Mx // 2:
                imin = max(0, sx * i - ns + 1)
                imax = min(nx, sx * i + ns + 1)
            else:
                imin_t = max(0, sx * (Mx - i - 1) - ns + 1)
                imax_t = min(nx, sx * (Mx - i - 1) + ns + 1)
                imin = max(0, nx - imax_t)
                imax = min(nx, nx - imin_t)

            if j < My // 2:
                jmin = max(0, sy * j - ns)
                jmax = min(ny, sy * j + ns)
            else:
                jmin_t = max(0, sy * (My - j - 1) - ns)
                jmax_t = min(ny, sy * (My - j - 1) + ns)
                jmin = max(0, ny - jmax_t)
                jmax = min(ny, ny - jmin_t)

            for ii in range(imin, imax):
                for jj in range(jmin, jmax):
                    node_set.append(nodes[ii, jj])
                    element_set.append(ii + nx * jj)
                    dvmap[ii, jj] = -1

            node_sets[name] = np.array(node_set, dtype=np.int32)
            element_sets[name] = np.array(element_set, dtype=np.int32)

    index = 0
    for i in range(nx // 2 + 1):
        for j in range(ny // 2 + 1):
            if dvmap[i, j] >= 0:
                dvmap[i, j] = index
                dvmap[nx - i, j] = index
                dvmap[i, ny - j] = index
                dvmap[nx - i, ny - j] = index
                index += 1

    return dvmap.reshape(-1), index, node_sets, element_sets


def cantilever_bcs(mesh: GridMesh, side="left"):
    """Dirichlet boundary: clamp both DOFs of every node on one edge.
    Returns the free-DOF indices (int32)."""
    nvars = 2 * mesh.nnodes
    fixed = np.zeros(nvars, dtype=bool)
    edges = {"left": mesh.nodes[0, :], "right": mesh.nodes[-1, :],
             "bottom": mesh.nodes[:, 0], "top": mesh.nodes[:, -1]}
    if side not in edges:
        raise ValueError(side)
    edge = edges[side]
    fixed[2 * edge] = True
    fixed[2 * edge + 1] = True
    return np.nonzero(~fixed)[0].astype(np.int32)
