"""Host-side domain decomposition of a structured grid over the ranks of a
shard axis.

Counterpart of ``eigd_tpu/parallel/grid.py``, the port's own copy (numpy
only, equal to JAX's integer for integer). The grid is partitioned into
contiguous node lines (constant-x columns of nodes, ``make_grid``'s
``nodes[i, j] = i*(ny+1) + j`` layout): rank d owns lines
``[d*L, (d+1)*L)`` and the element columns that start on them. A matvec
then needs one halo line from the right neighbour and sends one boundary
line of scatter contributions back.

``make_axis`` takes the place of JAX's ``make_mesh``: torch's counterpart
of a mesh axis is a process group, which needs one process per rank
(``parallel.launch``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_axis(group=None, device=None):
    """The shard axis over ``group`` (None: the default group, which
    ``torch.distributed.init_process_group`` must have started), its shards
    on ``device`` (default: the current CUDA device under NCCL, else the
    CPU)."""
    from ..ops.collective import Axis

    return Axis(group, device)


@dataclasses.dataclass(frozen=True)
class GridPartition:
    """Static description of a line-partitioned nx x ny grid.

    nx, ny : element grid dimensions (nx+1 node lines of ny+1 nodes each).
    ndof : DOFs per node (2 plane stress, 1 thermal).
    ndev : number of ranks on the shard axis.
    L : node lines per rank (nlines padded to ndev * L).
    """

    nx: int
    ny: int
    ndof: int
    ndev: int
    L: int

    @property
    def line_dofs(self):
        return self.ndof * (self.ny + 1)

    @property
    def nlines(self):
        return self.nx + 1

    @property
    def n_local(self):
        """Local (per-rank) padded DOF count."""
        return self.L * self.line_dofs

    @property
    def n_padded(self):
        """Global padded DOF count = ndev * n_local."""
        return self.ndev * self.n_local

    @property
    def n(self):
        """True global DOF count."""
        return self.nlines * self.line_dofs

    @property
    def elems_local(self):
        """Element slots per rank (L element columns of ny each)."""
        return self.L * self.ny

    @property
    def elems_padded(self):
        return self.ndev * self.elems_local


def make_partition(nx, ny, ndev, ndof=2, multiple=1) -> GridPartition:
    """``multiple``: round L up so each rank owns a multiple of this many
    lines (the sharded multigrid factor needs L % 2**shard_levels == 0 for
    rank-local grid transfers)."""
    L = -(-(nx + 1) // ndev)  # ceil
    L = -(-L // multiple) * multiple
    return GridPartition(nx=nx, ny=ny, ndof=ndof, ndev=ndev, L=L)


def element_gather_index(part: GridPartition) -> np.ndarray:
    """Map padded column-major element slots -> original element index.

    Slot s = d * elems_local + c_local * ny + j corresponds to global
    element column c = d*L + c_local, row j, i.e. original element index
    e = c + nx * j (make_grid layout). Padded slots (c >= nx) get -1.
    """
    nx, ny = part.nx, part.ny
    s = np.arange(part.elems_padded)
    dev = s // part.elems_local
    rem = s % part.elems_local
    c = dev * part.L + rem // ny
    j = rem % ny
    idx = np.where(c < nx, c + nx * j, -1)
    return idx.astype(np.int32)


def local_dof_map(part: GridPartition) -> np.ndarray:
    """(elems_local, 4*ndof) local *extended* DOF indices, identical on every
    rank. The extended local vector has L+1 lines (L owned + 1 halo).

    Element slot s = c_local * ny + j has nodes at (line, row):
    (c, j), (c+1, j), (c+1, j+1), (c, j+1) — matching make_grid's
    counter-clockwise node order so the same quadrature tables apply.
    """
    ny, ndof = part.ny, part.ndof
    s = np.arange(part.elems_local)
    c = s // ny
    j = s % ny
    node_line = np.stack([c, c + 1, c + 1, c], axis=1)  # (ne_l, 4)
    node_row = np.stack([j, j, j + 1, j + 1], axis=1)
    node_local = node_line * (ny + 1) + node_row  # local extended node id
    dofs = np.zeros((part.elems_local, 4 * ndof), dtype=np.int32)
    for k in range(ndof):
        dofs[:, k::ndof] = ndof * node_local + k
    return dofs


def pad_line_mask(part: GridPartition) -> np.ndarray:
    """(ndev, n_local) 1.0 for real DOFs, 0.0 for padded lines."""
    dev = np.arange(part.ndev)[:, None]
    line = np.arange(part.L)[None, :]
    real = (dev * part.L + line) < part.nlines
    mask = np.repeat(real.astype(np.float64), part.line_dofs, axis=1)
    return mask
