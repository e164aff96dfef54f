"""ls1-mardyn-tpu-torch: the PyTorch + CUDA port of ls1_mardyn_tpu.

The JAX package ``ls1_mardyn_tpu`` stays the reference; this package
mirrors its module paths and class names (``driver.MDSimulation``,
``rmm_engine.RMMEngine``, ``ops.rmm.RMMSimulation``, ...) so every
counterpart is found at the same place.  It imports torch and numpy,
never jax.

Slice 1 covers the single-component 1CLJ NVT main path: XML config ->
MDSimulation -> RMMEngine -> RMMSimulation, whose force and rebin
kernels are hand-written CUDA C++ for Hopper (csrc/, built at first
use by ops/_build.py).  On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.1.0"

import torch as _torch

# MD positions and forces are never TF32-tolerant: force full-precision
# f32 matmuls and convolutions, as the JAX package forces "highest"
# matmul precision at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
