"""Parameter layer (L1): frozen dataclasses with host-side precompute."""

from . import (
    aerosol,
    aerosol_species,
    common,
    config,
    convert,
    ice_nucleation,
    m1,
    m2,
    modal_nucleation,
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
from .config import (
    NAME_MAP,
    aerosol_activation_params_from_overrides,
    calibrated_overrides,
    calibrated_toml_path,
    load_toml_overrides,
    microphysics_1m_params_from_overrides,
    microphysics_2m_params_from_overrides,
    sb2006_from_overrides,
)
from .convert import (
    box_state_from_numpy,
    column_state_2m_from_numpy,
    column_state_from_numpy,
    column_state_p3_from_numpy,
    from_tree,
    gp_params_from_numpy,
    mlp_params_from_flax,
    p3_sandbox_state_from_numpy,
    parcel_state_from_numpy,
    trees_params_from_numpy,
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
from .modal_nucleation import (
    H2SO4NucleationParameters,
    MixedNucleationParameters,
    OrganicNucleationParameters,
)
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
