"""cloudmicrophysics_tpu_torch — the PyTorch/CUDA port of cloudmicrophysics_tpu.

Same layout, module names, function names and state types as the JAX
package (which stays the reference it is tested against), with
``torch.Tensor`` fields:

* ``utils/``      — small-number utilities, special functions, param structs
* ``parameters/`` — frozen parameter dataclasses (same fields and defaults)
* ``ops/``        — process rates (thermo, common, 0M, 1M, NonEq, 2M, P3,
                    ice nucleation)
* ``models/``     — fused tendencies and the 1M, 2M and 2M + P3 column steps
* ``parallel/``   — column sharding over a ``torch.distributed`` device
                    mesh (column data parallelism)
* ``kernels/``    — hand-written CUDA kernels for the fused hot path, each
                    beside its plain PyTorch version
* ``trace``       — spans at the step path's and set-up's layer boundaries
                    (recorded while a ``torch.profiler`` records) and
                    always-on counters (launches, library builds and loads,
                    set-up seconds)

Importing the package builds nothing: a kernel is compiled with ``nvcc``
the first time it is launched on a CUDA tensor.
"""

__version__ = "0.1.0"

from . import kernels, models, ops, parallel, parameters, trace, utils
