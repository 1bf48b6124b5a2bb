"""Global numerical configuration for eigd_tpu_torch.

Counterpart of ``eigd_tpu/config.py``. The solver state is float64 end to
end, and every f64 tensor is created with an explicit dtype, so no default
dtype is changed here. What is set is the precision of float32 products:
the multigrid V-cycle runs in f32 and its coarsest level is a dense f32
inverse applied as a matmul. TF32 (about three decimal digits) destroys
that inverse and the V-cycle's contraction, exactly as the bf16 passes of
a TPU f32 matmul destroyed the JAX package's f32 factors. So both cuBLAS
and cuDNN products run in full f32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
