"""Linear operators.

Counterpart of ``eigd_tpu/ops/operators.py``: an explicit dense matrix, a
diagonal, and the finite-element operator (per-element dense blocks plus a
DOF map). Every ``mv`` accepts a vector (n,) or a block (n, k). The
element matvec is a gather, a batched matmul and an ``index_add`` scatter
in place of JAX's ``segment_sum``.
"""

from __future__ import annotations

import torch


def element_dense(mats, dofs, n):
    """The dense (n, n) sum of per-element blocks ``mats`` placed at
    ``dofs`` (differentiable in mats)."""
    out = mats.new_zeros((n, n))
    return out.index_put((dofs[:, :, None], dofs[:, None, :]), mats,
                         accumulate=True)


class DenseOperator:
    """Explicit dense symmetric matrix operator."""

    def __init__(self, mat):
        self.mat = mat

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def mv(self, x):
        return self.mat @ x

    def to_dense(self):
        return self.mat


class DiagonalOperator:
    """Diagonal matrix operator."""

    def __init__(self, diag):
        self.diag = diag

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def mv(self, x):
        if x.ndim == 1:
            return self.diag * x
        return self.diag[:, None] * x

    def to_dense(self):
        return torch.diag(self.diag)


class ElementOperator:
    """Matrix-free finite-element operator A = sum_e P_e^T Ke[e] P_e.

    mats : (nelems, d, d) per-element dense matrices.
    dofs : (nelems, d) integer global DOF index of each element DOF.
    n : global number of DOFs.
    """

    def __init__(self, mats, dofs, n):
        self.mats = mats
        self.dofs = dofs
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.mats.dtype

    @property
    def device(self):
        return self.mats.device

    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        xe = x[self.dofs]  # (nelems, d, k)
        ye = torch.bmm(self.mats, xe)
        y = x.new_zeros((self.n, x.shape[1]))
        y = y.index_add(0, self.dofs.reshape(-1),
                        ye.reshape(-1, x.shape[1]))
        return y[:, 0] if squeeze else y

    def to_dense(self):
        return element_dense(self.mats, self.dofs, self.n)


def as_operator(obj):
    """An operator from a tensor: a (n,) tensor is a diagonal, an (n, n)
    one a dense matrix; any other object with an ``mv`` method passes
    through (a tensor's own ``Tensor.mv`` is not an operator's)."""
    if not isinstance(obj, torch.Tensor):
        if hasattr(obj, "mv"):
            return obj
        raise TypeError(f"Cannot interpret {type(obj)} as an operator")
    if obj.ndim == 1:
        return DiagonalOperator(obj)
    if obj.ndim == 2:
        return DenseOperator(obj)
    raise TypeError(f"Cannot interpret a {obj.ndim}-d tensor as an operator")
