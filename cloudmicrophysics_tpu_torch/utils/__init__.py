"""Numerics utilities (L0): special functions, parameter-struct machinery,
struct display and data artifacts."""

from . import artifacts, distributions, param, quadrature, show, special
from .artifacts import AIDA_ice_nucleation, ArtifactMissingError, artifacts_dir
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
from .show import field_units, show_params
