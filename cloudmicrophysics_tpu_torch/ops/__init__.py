"""Physics operators (L2-L4): elementwise process-rate functions."""

from . import (
    common,
    ice_nucleation,
    m0,
    m1,
    m2,
    noneq,
    p3,
    p3_processes,
    states,
    thermo,
)
from .states import MicroState, MicroState2M, ThermoState
