"""Linear operators.

Counterpart of ``eigd_tpu/ops/operators.py``: an explicit dense matrix, a
diagonal, and the finite-element operator (per-element dense blocks plus a
DOF map). Every ``mv`` accepts a vector (n,) or a block (n, k), and
calling an operator is its ``mv``. The element matvec is a gather, a
batched matmul and a scatter-add in place of JAX's ``segment_sum``
(``scatter_rows``: the same sums in the same order on every run, on the
CPU and on the card). ``reduce_operator_dense``, ``expand_vector`` and
``reduce_vector`` apply Dirichlet conditions by keeping the free DOFs.
"""

from __future__ import annotations

from typing import Union

import torch


def scatter_rows(vals, index, n):
    """A new (n, ...) tensor with out[index[i]] += vals[i]: ``index_add``
    on the CPU, ``index_put_`` with accumulate on CUDA, which sorts the
    index and sums each row's terms in order, where CUDA's ``index_add``
    sums them by atomics in a different order on every run."""
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    if vals.is_cuda:
        return out.index_put_((index,), vals, accumulate=True)
    return out.index_add_(0, index, vals)


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

    def __call__(self, x):
        return self.mv(x)

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

    def __call__(self, x):
        return self.mv(x)

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
        """A x, in the promoted dtype of A and x as JAX's einsum computes
        it (the mixed SIBK ladder hands f32 blocks to f64 operators)."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        dt = torch.promote_types(self.mats.dtype, x.dtype)
        x = x.to(dt)
        xe = x[self.dofs]  # (nelems, d, k)
        ye = torch.bmm(self.mats.to(dt), xe)
        y = scatter_rows(ye.reshape(-1, x.shape[1]), self.dofs.reshape(-1),
                         self.n)
        return y[:, 0] if squeeze else y

    def __call__(self, x):
        return self.mv(x)

    def to_dense(self):
        return element_dense(self.mats, self.dofs, self.n)


Operator = Union[DenseOperator, DiagonalOperator, ElementOperator]


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


def _index(free, device):
    return torch.as_tensor(free, dtype=torch.int64, device=device)


def reduce_operator_dense(op, free):
    """The free-free block of ``op``'s dense form, a ``DenseOperator``:
    Dirichlet conditions applied by keeping the free DOFs (``free``, their
    indices) rather than deleting rows and columns."""
    mat = op.to_dense()
    free = _index(free, mat.device)
    return DenseOperator(mat.index_select(0, free).index_select(1, free))


def expand_vector(vec, free, n):
    """A reduced vector (nfree, ...) scattered back to the full space
    (n, ...), zero on the fixed DOFs."""
    out = vec.new_zeros((n,) + tuple(vec.shape[1:]))
    return out.index_put((_index(free, vec.device),), vec)


def reduce_vector(vec, free):
    """The free entries of a full vector (n, ...) -> (nfree, ...)."""
    return vec.index_select(0, _index(free, vec.device))
