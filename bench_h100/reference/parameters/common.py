"""Shared small parameter structs: air / water properties, 0-moment params.

Reference: reference ``src/parameters/AirProperties.jl``,
``WaterProperties.jl``, ``Microphysics0M.jl``. Default values are the
ClimaParams registry defaults (documented in the reference docs, e.g.
``docs/src/Microphysics1M.md`` parameter tables).
"""

from __future__ import annotations

from ..utils.param import paramclass


@paramclass
class AirProperties:
    """Air properties (reference src/parameters/AirProperties.jl:11)."""

    K_therm: float = 2.4e-2   # thermal conductivity of air [W/m/K]
    D_vapor: float = 2.26e-5  # diffusivity of water vapor [m^2/s]
    nu_air: float = 1.6e-5    # kinematic viscosity of air [m^2/s]


@paramclass
class WaterProperties:
    """Water properties (reference src/parameters/WaterProperties.jl:11)."""

    rho_w: float = 1000.0     # density of liquid water [kg/m^3]
    rho_i: float = 916.7      # density of ice [kg/m^3]


@paramclass
class Parameters0M:
    """0-moment scheme parameters
    (reference src/parameters/Microphysics0M.jl:11)."""

    tau_precip: float = 1000.0  # precipitation timescale [s]
    qc_0: float = 5e-6          # condensate precipitation threshold [kg/kg]
    S_0: float = 0.02           # supersaturation precipitation threshold [-]


@paramclass
class Microphysics0MParams:
    """Container (reference src/parameters/Microphysics0MParams.jl:20)."""

    precip: Parameters0M


def microphysics_0m_params(**overrides) -> Microphysics0MParams:
    return Microphysics0MParams(precip=Parameters0M(**overrides))
