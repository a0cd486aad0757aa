"""Parameter layer (L1): frozen dataclasses with host-side precompute."""

from . import (
    common,
    convert,
    ice_nucleation,
    m1,
    m2,
    p3,
    terminal_velocity,
    thermodynamics,
)
from .common import (
    AirProperties,
    Microphysics0MParams,
    Parameters0M,
    WaterProperties,
    microphysics_0m_params,
)
from .convert import (
    column_state_2m_from_numpy,
    column_state_from_numpy,
    column_state_p3_from_numpy,
    from_tree,
)
from .ice_nucleation import (
    Frostenberg2023,
    IceNucleationParameters,
    Koop2000,
    Mohler2006,
    MorrisonMilbrandt2014,
    NIceProxyDepletion,
    RainFreezing,
    ice_nucleation_parameters,
)
from .m1 import Microphysics1MParams, microphysics_1m_params
from .m2 import Microphysics2MParams, microphysics_2m_params, sb2006
from .p3 import (
    IceNumberAdjustment,
    P3IceParams,
    ParametersP3,
    SlopeConstant,
    SlopePowerLaw,
    p3_ice_params,
    parameters_p3,
)
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
