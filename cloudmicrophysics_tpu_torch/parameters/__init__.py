"""Parameter layer (L1): frozen dataclasses with host-side precompute."""

from . import common, convert, ice_nucleation, m1, terminal_velocity, thermodynamics
from .common import (
    AirProperties,
    Microphysics0MParams,
    Parameters0M,
    WaterProperties,
    microphysics_0m_params,
)
from .convert import column_state_from_numpy, from_tree
from .ice_nucleation import Frostenberg2023
from .m1 import Microphysics1MParams, microphysics_1m_params
from .terminal_velocity import (
    Blk1MVelType,
    Blk1MVelTypeRain,
    Blk1MVelTypeSnow,
    Chen2022VelType,
    Chen2022VelTypeLargeIce,
    Chen2022VelTypeRain,
    Chen2022VelTypeSmallIce,
    SB2006VelType,
    StokesRegimeVelType,
    TerminalVelocityParams,
    blk1m_vel_type,
    chen2022_vel_type,
    terminal_velocity_params,
)
from .thermodynamics import ThermodynamicsParameters
