"""Physics operators (L2-L4): elementwise process-rate functions."""

from . import common, m0, m1, m2, noneq, states, thermo
from .states import MicroState, MicroState2M, ThermoState
