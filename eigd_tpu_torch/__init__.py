"""eigd_tpu_torch - the PyTorch/CUDA port of eigd_tpu.

Adjoint derivatives of functions of the eigenvalues and eigenvectors of
``A(x) phi = lam B(x) phi``, with ``eigh_gen`` (and ``eigh_gen_dense`` for
explicit matrices) as a ``torch.autograd.Function`` whose backward pass
runs the adjoint solve. The package mirrors ``eigd_tpu``'s layout
(``fem/``, ``ops/``, ``models/``) and exports the ported names under
JAX's; the two Pallas TPU stencil kernels are hand-written CUDA kernels
(``csrc/stencil.cu``, wrapped by ``ops/cuda_stencil.py``) built with nvcc
at first use. It imports torch and never jax.
"""

from . import config as _config  # noqa: F401  (f32 matmul precision)
from .ops.adjoint import (add_eig_total_derivative,
                          are_eigenvalues_repeated,
                          eval_adjoint_residual_norm,
                          generate_adjoint_correction, laa, pcpg, pgmres,
                          sibk)
from .ops.autodiff import EigProblem, EighGenConfig, eigh_gen, eigh_gen_dense
from .ops.blockfactor import BCRFactor, BlockTridiagFactor, RefinedFactor
from .ops.factor import (CGFactor, CholeskyFactor, EighFactor,
                         make_shift_factor)
from .ops.lanczos import (LanczosResult, block_lanczos_solve,
                          lanczos_iteration, lanczos_solve)
from .ops.multigrid import GridMGFactor
from .ops.operators import (DenseOperator, DiagonalOperator, ElementOperator,
                            as_operator)
from .ops.stencil import GridStencilOperator

__version__ = "0.1.0"

__all__ = [
    "DenseOperator",
    "DiagonalOperator",
    "ElementOperator",
    "as_operator",
    "GridStencilOperator",
    "CholeskyFactor",
    "EighFactor",
    "CGFactor",
    "make_shift_factor",
    "GridMGFactor",
    "BlockTridiagFactor",
    "BCRFactor",
    "RefinedFactor",
    "LanczosResult",
    "lanczos_iteration",
    "lanczos_solve",
    "block_lanczos_solve",
    "laa",
    "sibk",
    "pcpg",
    "pgmres",
    "generate_adjoint_correction",
    "add_eig_total_derivative",
    "eval_adjoint_residual_norm",
    "are_eigenvalues_repeated",
    "EigProblem",
    "EighGenConfig",
    "eigh_gen",
    "eigh_gen_dense",
]
