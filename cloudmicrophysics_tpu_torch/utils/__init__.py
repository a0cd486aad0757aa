"""Numerics utilities (L0): special functions and parameter-struct machinery."""

from . import param, special
from .param import paramclass, replace, static_field
from .special import (
    clamp_to_nonneg,
    eps_numerics,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    eps_numerics_P3_B,
    fac,
    float_dtype,
)
