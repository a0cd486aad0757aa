"""Physics operators (L2-L4): elementwise process-rate functions."""

from . import (
    aerosol_activation,
    common,
    diagnostics,
    ice_nucleation,
    m0,
    m1,
    m2,
    noneq,
    nucleation,
    p3,
    p3_processes,
    states,
    susceptibility,
    thermo,
)
from .states import MicroState, MicroState2M, ThermoState
