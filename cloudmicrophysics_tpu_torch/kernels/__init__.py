"""Hand-written CUDA kernels for the fused hot paths.

The physics lives in ``ops``/``models`` as eager PyTorch; each kernel here
computes the same step in one pass and sits beside its plain version,
which CPU tensors take. Nothing is compiled at import: a kernel is built
with ``nvcc`` (see ``_build``) the first time it is launched.
"""

from .column1m import (
    kernel_params,
    pack_state,
    step_column_1m_fused,
    step_column_1m_fused_packed,
    unpack_state,
)
from .column2m import (
    kernel_params_2m,
    pack_state_2m,
    step_column_2m_fused,
    step_column_2m_fused_packed,
    unpack_state_2m,
)
from .column_p3 import kernel_params_p3, step_column_p3_fused
