"""ls1-mardyn-tpu-torch: the PyTorch + CUDA port of ``ls1_mardyn_tpu``.

The JAX package ``ls1_mardyn_tpu`` stays the reference; this package
mirrors its module paths and class names (``driver.MDSimulation``,
``rmm_engine.RMMEngine``, ``ops.rmm.RMMSimulation``, ...) so every
counterpart is found at the same place.  It imports torch and numpy,
never jax.

Two engines sit under ``driver.MDSimulation``: the RMM dense engine
for single-component 1CLJ scenes (RMMEngine -> RMMSimulation) and the
general single-device engine (``simulation.SingleChipSimulation``:
rigid-body integrator, all seven site-site interactions, component-wise,
undirected and region thermostats) with the 1CLJ cell kernels, the N^2
oracle or the plain multi-site cell traversal as its force path.  The
force and rebin kernels are hand-written CUDA C++ for Hopper (csrc/,
built at first use by ops/_build.py).  On a CPU tensor every kernel
wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

import torch as _torch

# MD positions and forces are never TF32-tolerant: force full-precision
# f32 matmuls and convolutions, as the JAX package forces "highest"
# matmul precision at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
