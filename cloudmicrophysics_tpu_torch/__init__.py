"""cloudmicrophysics_tpu_torch — the PyTorch/CUDA port of cloudmicrophysics_tpu.

Same layout, module names, function names and state types as the JAX
package (which stays the reference it is tested against), with
``torch.Tensor`` fields:

* ``utils/``      — small-number utilities, special functions, param structs
* ``parameters/`` — frozen parameter dataclasses (same fields and defaults)
* ``ops/``        — elementwise process rates (thermo, common, 0M, 1M, NonEq)
* ``models/``     — fused 1M tendencies and the column step
* ``kernels/``    — hand-written CUDA kernels for the fused hot path, each
                    beside its plain PyTorch version

Importing the package builds nothing: a kernel is compiled with ``nvcc``
the first time it is launched on a CUDA tensor.
"""

__version__ = "0.1.0"

from . import kernels, models, ops, parameters, utils
