"""Small-number utilities and elementwise special functions (L0).

Port of ``cloudmicrophysics_tpu/utils/special.py:70-205``: the dtype
helpers, the two-tier smallness thresholds (reference
``src/Utilities.jl:254-341``), and the elementwise functions the process
rates use. The JAX package builds ``expm1``/``atanh``/``lgamma`` from the
primitives a TPU kernel can lower; here they are PyTorch's own.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "atanh",
    "cbrt",
    "clamp_to_nonneg",
    "eps_numerics",
    "eps_numerics_2M_M",
    "eps_numerics_2M_N",
    "eps_numerics_P3_B",
    "expm1",
    "fac",
    "float_dtype",
    "floatmin",
    "gamma",
    "lgamma",
    "machine_eps",
]


def float_dtype(*args) -> torch.dtype:
    """The common floating dtype of the tensor arguments.

    Python numbers do not take part (as JAX's weak types do not); with no
    floating tensor among the arguments the result is float64, the dtype of
    a Python float.
    """
    dtypes = [a.dtype for a in args if isinstance(a, torch.Tensor)]
    if dtypes:
        dt = functools.reduce(torch.promote_types, dtypes)
        if dt.is_floating_point:
            return dt
    return torch.float64


def machine_eps(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).eps)


def floatmin(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).tiny)


def eps_numerics(dt: torch.dtype) -> float:
    """1-moment presence threshold: ``cbrt(floatmin)`` (~2.3e-13 @ f32)."""
    return float(floatmin(dt) ** (1.0 / 3.0))


def eps_numerics_2M_M(dt: torch.dtype) -> float:
    """2-moment mass presence threshold: machine eps."""
    return machine_eps(dt)


def eps_numerics_2M_N(dt: torch.dtype) -> float:
    """2-moment number presence threshold: machine eps."""
    return machine_eps(dt)


def eps_numerics_P3_B(dt: torch.dtype) -> float:
    """P3 rime-volume (B_rim) presence threshold: machine eps."""
    return machine_eps(dt)


def clamp_to_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Domain sanitization (NOT a physical threshold): ``max(x, 0)``."""
    return torch.clamp(x, min=0.0)


def fac(n: int) -> int:
    """Integer factorial, host-side (reference src/Utilities.jl:299-308)."""
    if not 0 <= n <= 20:
        raise ValueError(f"fac(n) is defined for 0 <= n <= 20, got {n}")
    return math.factorial(n)


def expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.expm1(x)


def atanh(x: torch.Tensor) -> torch.Tensor:
    return torch.atanh(x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Signed cube root."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def lgamma(a):
    """``log Gamma(a)``; a Python number is evaluated on the host, so a
    parameter-only factor stays a Python float."""
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return math.lgamma(a)
    return torch.lgamma(a)


def gamma(a):
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return math.exp(math.lgamma(a))
    return torch.exp(torch.lgamma(a))
