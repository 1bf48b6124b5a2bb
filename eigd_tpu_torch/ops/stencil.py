"""Structured-grid stencil operators: gather/scatter-free FE matvecs.

Counterpart of ``eigd_tpu/ops/stencil.py``. On a regular grid the assembled
FE operator is a 9-point nodal stencil with (ndof, ndof) coupling blocks,
stored as W of shape (nx+1, ny+1, 3, 3, ndof, ndof). The stencil is
assembled from the element matrices with 16 slice-adds, so the build is
differentiable by ``torch.autograd``.

Node layout matches fem.model.make_grid: node(i, j) = i*(ny+1) + j, element
e = i + nx*j with corners [(i,j), (i+1,j), (i+1,j+1), (i,j+1)].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_stencil
from .operators import element_dense

# corner -> (di, dj) within the element
_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))


def stencil_from_elements(emats, nx, ny, ndof):
    """Element matrices -> nodal stencil W (nx+1, ny+1, 3, 3, ndof, ndof).

    W[i, j, 1+di, 1+dj] is the coupling block from node (i+di, j+dj) onto
    node (i, j). emats is (nx*ny, 4*ndof, 4*ndof) in e = i + nx*j order.
    """
    d4 = 4 * ndof
    Ke = emats.reshape(ny, nx, d4, d4).transpose(0, 1)  # (nx, ny, ., .)
    W = emats.new_zeros((nx + 1, ny + 1, 3, 3, ndof, ndof))
    for a, (ai, aj) in enumerate(_CORNERS):
        for b, (bi, bj) in enumerate(_CORNERS):
            blk = Ke[:, :, ndof * a: ndof * (a + 1), ndof * b: ndof * (b + 1)]
            W[ai: ai + nx, aj: aj + ny, 1 + bi - ai, 1 + bj - aj] += blk
    return W


def stencil_matvec(W, x, nx, ny, ndof):
    """y = A x with the 9-point block stencil; x is (n,) or (n, k).

    Plain PyTorch, differentiable in W and x, with JAX's order of
    operations. It is the plain twin of the f64 kernel (K2) and the matvec
    of the "plain" V-cycle.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    xg = x.reshape(nx + 1, ny + 1, ndof, k)
    xp = F.pad(xg, (0, 0, 0, 0, 1, 1, 1, 1))
    shifts = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            shifts.append((W[:, :, 1 + di, 1 + dj],
                           xp[1 + di: 2 + di + nx, 1 + dj: 2 + dj + ny]))
    rows = []
    for a in range(ndof):
        acc = None
        for Ws, xs in shifts:
            for b in range(ndof):
                t = Ws[:, :, a, b, None] * xs[:, :, b, :]
                acc = t if acc is None else acc + t
        rows.append(acc)
    out = torch.stack(rows, dim=2).reshape((nx + 1) * (ny + 1) * ndof, k)
    return out[:, 0] if squeeze else out


class GridStencilOperator:
    """FE operator on a regular grid: stencil matvec + element-matrix view.

    ``with_kernels()`` attaches the plane forms of the stencil that the
    hand-written kernels read; ``mv`` then sends f64 inputs to K2 and f32
    inputs to K1 (``cuda_stencil``), and everything else to the plain
    ``stencil_matvec``.
    """

    def __init__(self, mats, dofs, n, W, grid_shape, ndof=2, extra_diag=None,
                 Wp32=None, Wp64=None):
        self.mats = mats  # (nelems, d, d) element matrices
        self.dofs = dofs  # (nelems, d) global DOF map
        self.n = n
        self.W = W  # (nx+1, ny+1, 3, 3, ndof, ndof), extra_diag folded in
        self.grid_shape = tuple(grid_shape)
        self.ndof = ndof
        # (n,) diagonal beside the element matrices (the unit diagonal of
        # masked Dirichlet DOFs), kept for the factors built from mats
        self.extra_diag = extra_diag
        self.Wp32 = Wp32  # f32 planes for K1
        self.Wp64 = Wp64  # f64 planes for K2

    @classmethod
    def from_element_operator(cls, op, grid_shape, ndof=2, extra_diag=None):
        """The stencil of an ElementOperator, with ``extra_diag`` (n,)
        folded into W's centre tap."""
        nx, ny = grid_shape
        W = stencil_from_elements(op.mats, nx, ny, ndof)
        if extra_diag is not None:
            dg = extra_diag.reshape(nx + 1, ny + 1, ndof)
            for d in range(ndof):
                W[:, :, 1, 1, d, d] += dg[:, :, d]
        return cls(op.mats, op.dofs, op.n, W, grid_shape, ndof,
                   extra_diag=extra_diag)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.W.dtype

    @property
    def device(self):
        return self.W.device

    def with_kernels(self):
        """Copy of the operator carrying the kernels' plane stencils.

        Applied at the solver boundary only (autodiff._kernel_ops): the
        differentiable assemble path of the eigh_gen backward pass builds
        plain operators, so no kernel is ever inside the autograd graph.
        """
        W = self.W.detach()
        Wp64 = (cuda_stencil.stencil_planes(W, self.ndof, torch.float64)
                if W.dtype == torch.float64 else None)
        return GridStencilOperator(
            self.mats, self.dofs, self.n, self.W, self.grid_shape, self.ndof,
            extra_diag=self.extra_diag,
            Wp32=cuda_stencil.stencil_planes(W, self.ndof, torch.float32),
            Wp64=Wp64)

    def planes_only(self):
        """Copy holding the f64 planes that K2 reads and nothing else, W a
        view of them: ``mv`` sends a CUDA f64 input to K2 and a CPU one to
        the plain stencil. What a factor keeps of its matrix to apply the
        couplings (``BCRFactor``'s ``coupling``)."""
        Wp64 = cuda_stencil.stencil_planes(self.W.detach(), self.ndof,
                                           torch.float64)
        return GridStencilOperator(
            None, None, self.n, cuda_stencil.planes_to_stencil(Wp64,
                                                               self.ndof),
            self.grid_shape, self.ndof, Wp64=Wp64)

    @property
    def nbytes(self):
        """Bytes of the stencil and its planes, each storage once."""
        held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (self.W, self.Wp32, self.Wp64) if t is not None}
        return sum(held.values())

    def to_dense(self):
        """The dense (n, n) matrix, summed from the element matrices, plus
        the extra diagonal."""
        out = element_dense(self.mats, self.dofs, self.n)
        if self.extra_diag is not None:
            out = out + torch.diag(self.extra_diag)
        return out

    def mv(self, x):
        nx, ny = self.grid_shape
        if self.Wp64 is not None and x.dtype == torch.float64:
            return cuda_stencil.stencil_matvec64(self.Wp64, x, nx, ny,
                                                 self.ndof)
        if self.Wp32 is not None and x.dtype == torch.float32:
            return cuda_stencil.stencil_matvec32(self.Wp32, x, nx, ny,
                                                 self.ndof)
        return stencil_matvec(self.W, x, nx, ny, self.ndof)

    def __call__(self, x):
        return self.mv(x)
