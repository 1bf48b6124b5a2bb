"""The finite-element operator.

Counterpart of ``ElementOperator`` in ``eigd_tpu/ops/operators.py``: a
small class holding per-element dense blocks plus a DOF map. ``mv``
accepts a vector (n,) or a block (n, k); it is a gather, a batched matmul
and an ``index_add`` scatter in place of JAX's ``segment_sum``. The dense
and diagonal operators wait for the dense factors (ROADMAP queue 1).
"""

from __future__ import annotations

import torch


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
