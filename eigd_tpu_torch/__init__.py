"""eigd_tpu_torch - the PyTorch/CUDA port of eigd_tpu.

Adjoint derivatives of functions of the eigenvalues and eigenvectors of
``A(x) phi = lam B(x) phi``, with ``eigh_gen`` as a
``torch.autograd.Function`` whose backward pass runs the adjoint solve.
The package mirrors ``eigd_tpu``'s layout (``fem/``, ``ops/``,
``models/``); the two Pallas TPU stencil kernels are hand-written CUDA
kernels (``csrc/stencil.cu``, wrapped by ``ops/cuda_stencil.py``) built
with nvcc at first use. It imports torch and never jax.
"""

from . import config as _config  # noqa: F401  (f32 matmul precision)
from .ops.adjoint import (are_eigenvalues_repeated,
                          eval_adjoint_residual_norm,
                          generate_adjoint_correction, laa, sibk)
from .ops.autodiff import EigProblem, EighGenConfig, eigh_gen
from .ops.lanczos import LanczosResult, block_lanczos_solve
from .ops.multigrid import GridMGFactor
from .ops.operators import ElementOperator
from .ops.stencil import GridStencilOperator

__version__ = "0.1.0"

__all__ = [
    "ElementOperator",
    "GridStencilOperator",
    "GridMGFactor",
    "LanczosResult",
    "block_lanczos_solve",
    "laa",
    "sibk",
    "generate_adjoint_correction",
    "eval_adjoint_residual_norm",
    "are_eigenvalues_repeated",
    "EigProblem",
    "EighGenConfig",
    "eigh_gen",
]
