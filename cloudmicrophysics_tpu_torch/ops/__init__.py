"""Physics operators (L2-L4): elementwise process-rate functions."""

from . import common, m0, m1, noneq, states, thermo
from .states import MicroState, ThermoState
