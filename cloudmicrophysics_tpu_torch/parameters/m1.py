"""1-moment microphysics parameters.

Reference: reference ``src/parameters/Microphysics1M.jl`` (particle
structs, kwdef defaults computed at construction),
``Microphysics1MOptions.jl`` (singleton option types + per-process params),
``Microphysics1MParams.jl`` (container). Default values are the ClimaParams
registry defaults documented in ``docs/src/Microphysics1M.md`` tables.

Option selection is a Python value (a string, or None to disable a
process) that picks code paths, like Julia's type-level dispatch on
singleton option types. The fused CUDA kernel supports the default
selection; the eager functions support them all.
"""

from __future__ import annotations

import math
from typing import Optional

from ..utils.param import paramclass, static_field
from .common import AirProperties
from .terminal_velocity import Blk1MVelType, blk1m_vel_type

PI = math.pi


# ---------------------------------------------------------------------------
# Particle property structs (reference src/parameters/Microphysics1M.jl:11-365)
# ---------------------------------------------------------------------------

@paramclass
class ParticlePDFSnow:
    """Snow size distribution: n0 = mu * (rho q_sno)^nu (Kaul 2015 Eq A1)."""

    mu: float = 4.36e9  # [1/m^4] (times rho0^nu, rho0 = 1 kg/m^3)
    nu: float = 0.63


@paramclass
class ParticlePDFIceRain:
    """Fixed-intercept Marshall-Palmer distribution."""

    n0: float  # [1/m^4]


@paramclass
class ParticleMass:
    """Mass(radius) power law: m(r) = m0 chim (r/r0)^(me + dm)."""

    r0: float
    m0: float
    me: float
    dm: float
    chim: float
    gamma_coeff: float  # precomputed gamma(me + dm + 1)


def particle_mass(r0, m0, me, dm=0.0, chim=1.0) -> ParticleMass:
    return ParticleMass(
        r0=r0, m0=m0, me=me, dm=dm, chim=chim,
        gamma_coeff=math.gamma(me + dm + 1),
    )


@paramclass
class ParticleArea:
    """Area(radius) power law: a(r) = a0 chia (r/r0)^(ae + da)."""

    a0: float
    ae: float
    da: float
    chia: float


@paramclass
class Ventilation:
    a: float
    b: float


@paramclass
class SnowAspectRatio:
    phi: float = 0.15   # aspect ratio [-]
    kappa: float = 1.0 / 3.0  # Chen2022 aspect-ratio exponent


@paramclass
class Acnv1M:
    """Kessler-type autoconversion parameters."""

    tau: float          # timescale [s]
    q_threshold: float  # [kg/kg]
    k: float            # logistic steepness [-]


@paramclass
class VarTimescaleAcnv:
    """Variable-timescale autoconversion (Azimi et al. 2023)."""

    tau: float = 1000.0
    alpha: float = 1.0
    Nc: float = 1e8     # prescribed droplet number [1/m^3]


@paramclass
class CloudLiquid:
    """Cloud liquid condensate (reference src/parameters/Microphysics1M.jl:129)."""

    rho_w: float = 1000.0
    r_eff: float = 14e-6
    N_0: float = 5e8    # sedimentation number concentration [1/m^3]


@paramclass
class CloudIce:
    """Cloud ice condensate (reference src/parameters/Microphysics1M.jl:158).

    ``rho_i`` is the *apparent* density of cloud ice crystals
    (ClimaParams ``cloud_ice_apparent_density`` = 500, validated against the
    reference snow-autoconversion regression value at
    test/microphysics1M_tests.jl:326-335)."""

    pdf: ParticlePDFIceRain
    mass: ParticleMass
    rho_i: float = 500.0
    r_eff: float = 25e-6
    N_0: float = 5e8


def cloud_ice(
    rho_i=500.0, r0=1e-5, me=3.0, dm=0.0, chim=1.0, n0=2e7,
    r_eff=25e-6, N_0=5e8,
) -> CloudIce:
    # m0 = rho_i * r0^me * 4pi/3 (reference Microphysics1M.jl:202-205)
    m0 = rho_i * r0**me * PI * 4 / 3
    return CloudIce(
        pdf=ParticlePDFIceRain(n0=n0),
        mass=particle_mass(r0, m0, me, dm, chim),
        rho_i=rho_i, r_eff=r_eff, N_0=N_0,
    )


@paramclass
class Rain:
    """Rain (reference src/parameters/Microphysics1M.jl:210)."""

    pdf: ParticlePDFIceRain
    mass: ParticleMass
    area: ParticleArea
    vent: Ventilation


def rain(
    rho_w=1000.0, r0=1e-3, me=3.0, dm=0.0, chim=1.0,
    ae=2.0, da=0.0, chia=1.0, n0=1.6e7, vent_a=1.5, vent_b=0.53,
) -> Rain:
    m0 = rho_w * r0**me * PI * 4 / 3
    a0 = PI * r0**ae
    return Rain(
        pdf=ParticlePDFIceRain(n0=n0),
        mass=particle_mass(r0, m0, me, dm, chim),
        area=ParticleArea(a0=a0, ae=ae, da=da, chia=chia),
        vent=Ventilation(a=vent_a, b=vent_b),
    )


@paramclass
class Snow:
    """Snow (reference src/parameters/Microphysics1M.jl:270)."""

    pdf: ParticlePDFSnow
    mass: ParticleMass
    area: ParticleArea
    vent: Ventilation
    aspr: SnowAspectRatio
    rho_i: float = 100.0  # snow apparent density [kg/m^3]
    gamma_aspect_oblate: float = 1.0
    gamma_aspect_prolate: float = 1.0


def snow(
    rho_i=100.0, r0=1e-3, me=2.0, dm=0.0, chim=1.0,
    ae=2.0, da=0.0, chia=1.0, mu=4.36e9, nu=0.63,
    vent_a=0.65, vent_b=0.44, phi=0.15, kappa=1.0 / 3.0,
) -> Snow:
    m0 = r0**me / 10  # Grabowski 1998 eq 6b
    a0 = 0.3 * PI * r0**ae
    # Oblate: alpha = me + dm - 3/2 (ae + da); Prolate: 3(ae+da) - 2(me+dm)
    alpha_oblate = me + dm - 1.5 * (ae + da)
    alpha_prolate = 3 * (ae + da) - 2 * (me + dm)
    return Snow(
        pdf=ParticlePDFSnow(mu=mu, nu=nu),
        mass=particle_mass(r0, m0, me, dm, chim),
        area=ParticleArea(a0=a0, ae=ae, da=da, chia=chia),
        vent=Ventilation(a=vent_a, b=vent_b),
        aspr=SnowAspectRatio(phi=phi, kappa=kappa),
        rho_i=rho_i,
        gamma_aspect_oblate=math.gamma(alpha_oblate + 4) / math.gamma(4.0),
        gamma_aspect_prolate=math.gamma(alpha_prolate + 4) / math.gamma(4.0),
    )


# ---------------------------------------------------------------------------
# Process options (reference src/parameters/Microphysics1MOptions.jl)
#
# Static strings mirroring the singleton option types; None disables a
# process.
# ---------------------------------------------------------------------------

CLOUD_LIQUID_FORMATION = "CloudLiquidFormation"
CONSTANT_TIMESCALE = "ConstantTimescale"
TEMPERATURE_DEPENDENT = "TemperatureDependent"
CLOUD_ICE_MELT = "CloudIceMelt"
KESSLER_1M = "Kessler1M"
PRESCRIBED_ND = "PrescribedNd"
NO_SUPERSATURATION = "NoSupersaturation"
WITH_SUPERSATURATION = "WithSupersaturation"
RAIN_EVAPORATION = "RainEvaporation"
SUBLIMATION_ONLY = "SublimationOnly"
DEPOSITION_AND_SUBLIMATION = "DepositionAndSublimation"
SNOW_MELT = "SnowMelt"
CLOUD_LIQUID_RAIN_ACCRETION = "CloudLiquidRainAccretion"
CLOUD_LIQUID_SNOW_ACCRETION = "CloudLiquidSnowAccretion"
CLOUD_ICE_RAIN_ACCRETION = "CloudIceRainAccretion"
CLOUD_ICE_SNOW_ACCRETION = "CloudIceSnowAccretion"
RAIN_SNOW_ACCRETION = "RainSnowAccretion"


@paramclass
class Microphysics1MOptions:
    """13-slot process selection (all static)
    (reference src/parameters/Microphysics1MOptions.jl:257-287)."""

    cloud_liquid_formation: Optional[str] = static_field(CLOUD_LIQUID_FORMATION)
    cloud_ice_formation: Optional[str] = static_field(CONSTANT_TIMESCALE)
    cloud_ice_melt: Optional[str] = static_field(CLOUD_ICE_MELT)
    rain_autoconversion: Optional[str] = static_field(KESSLER_1M)
    snow_autoconversion: Optional[str] = static_field(NO_SUPERSATURATION)
    rain_condensation_evaporation: Optional[str] = static_field(RAIN_EVAPORATION)
    snow_deposition_sublimation: Optional[str] = static_field(
        DEPOSITION_AND_SUBLIMATION
    )
    snow_melt: Optional[str] = static_field(SNOW_MELT)
    cloud_liquid_rain_accretion: Optional[str] = static_field(
        CLOUD_LIQUID_RAIN_ACCRETION
    )
    cloud_liquid_snow_accretion: Optional[str] = static_field(
        CLOUD_LIQUID_SNOW_ACCRETION
    )
    cloud_ice_rain_accretion: Optional[str] = static_field(
        CLOUD_ICE_RAIN_ACCRETION
    )
    cloud_ice_snow_accretion: Optional[str] = static_field(
        CLOUD_ICE_SNOW_ACCRETION
    )
    rain_snow_accretion: Optional[str] = static_field(RAIN_SNOW_ACCRETION)


@paramclass
class RelaxationParams:
    tau_relax: float = 10.0  # [s]


@paramclass
class TempDependentIceFormation:
    """TemperatureDependent cloud ice formation: Frostenberg INP tau_dep."""

    tau_relax: float = 10.0
    # Frostenberg2023 parameters filled in by the ice-nucleation layer
    frostenberg: object = None


@paramclass
class SnowAcnvWithSupersat:
    r_ice_snow: float = 62.5e-6  # [m] (Harrington 1995)


@paramclass
class CollisionEff:
    e: float


@paramclass
class RainSnowCollisionEff:
    e: float = 1.0
    coeff_disp: float = 0.2  # velocity dispersion coefficient


@paramclass
class ProcessParams1M:
    """Per-process parameter data, mirroring the options 1:1
    (reference src/parameters/Microphysics1MOptions.jl:379-397)."""

    cloud_liquid_formation: Optional[RelaxationParams]
    cloud_ice_formation: Optional[object]
    cloud_ice_melt: Optional[object] = None
    rain_autoconversion: Optional[object] = None
    snow_autoconversion: Optional[object] = None
    rain_condensation_evaporation: Optional[object] = None
    snow_deposition_sublimation: Optional[object] = None
    snow_melt: Optional[object] = None
    cloud_liquid_rain_accretion: Optional[CollisionEff] = None
    cloud_liquid_snow_accretion: Optional[CollisionEff] = None
    cloud_ice_rain_accretion: Optional[CollisionEff] = None
    cloud_ice_snow_accretion: Optional[CollisionEff] = None
    rain_snow_accretion: Optional[RainSnowCollisionEff] = None


def process_params_for(option: Optional[str], overrides: dict):
    """Build the parameter data a selected option needs
    (reference src/parameters/Microphysics1MOptions.jl:305-373)."""
    if option is None:
        return None
    o = overrides.get(option, {})
    if option == CLOUD_LIQUID_FORMATION:
        return RelaxationParams(**{"tau_relax": o.get("tau_relax", 10.0)})
    if option == CONSTANT_TIMESCALE:
        return RelaxationParams(**{"tau_relax": o.get("tau_relax", 10.0)})
    if option == TEMPERATURE_DEPENDENT:
        from .ice_nucleation import Frostenberg2023

        return TempDependentIceFormation(
            tau_relax=o.get("tau_relax", 10.0),
            frostenberg=o.get("frostenberg", Frostenberg2023()),
        )
    if option == KESSLER_1M:
        return Acnv1M(
            tau=o.get("tau", 1000.0),
            q_threshold=o.get("q_threshold", 5e-4),
            k=o.get("k", 2.0),
        )
    if option == PRESCRIBED_ND:
        return VarTimescaleAcnv(
            tau=o.get("tau", 1000.0),
            alpha=o.get("alpha", 1.0),
            Nc=o.get("Nc", 1e8),
        )
    if option == NO_SUPERSATURATION:
        return Acnv1M(
            tau=o.get("tau", 100.0),
            q_threshold=o.get("q_threshold", 1e-6),
            k=o.get("k", 2.0),
        )
    if option == WITH_SUPERSATURATION:
        return SnowAcnvWithSupersat(r_ice_snow=o.get("r_ice_snow", 62.5e-6))
    if option == CLOUD_LIQUID_RAIN_ACCRETION:
        return CollisionEff(e=o.get("e", 0.8))
    if option == CLOUD_LIQUID_SNOW_ACCRETION:
        return CollisionEff(e=o.get("e", 0.1))
    if option == CLOUD_ICE_RAIN_ACCRETION:
        return CollisionEff(e=o.get("e", 1.0))
    if option == CLOUD_ICE_SNOW_ACCRETION:
        return CollisionEff(e=o.get("e", 0.1))
    if option == RAIN_SNOW_ACCRETION:
        return RainSnowCollisionEff(
            e=o.get("e", 1.0), coeff_disp=o.get("coeff_disp", 0.2)
        )
    # Options carrying no parameters (melt, evaporation, dep/subl)
    return None


@paramclass
class CloudPhaseParams1M:
    liquid: CloudLiquid
    ice: CloudIce


@paramclass
class PrecipPhaseParams1M:
    rain: Rain
    snow: Snow


@paramclass
class Microphysics1MParams:
    """Unified 1-moment parameter container
    (reference src/parameters/Microphysics1MParams.jl:84-120)."""

    processes: Microphysics1MOptions
    process_params: ProcessParams1M
    cloud: CloudPhaseParams1M
    precip: PrecipPhaseParams1M
    air_properties: AirProperties
    terminal_velocity: Blk1MVelType


def microphysics_1m_params(
    process_overrides: dict | None = None, **options_kwargs
) -> Microphysics1MParams:
    """Build the default 1M parameter set; ``options_kwargs`` override the
    option selection (use None to disable a process), ``process_overrides``
    maps option name -> dict of parameter overrides."""
    processes = Microphysics1MOptions(**options_kwargs)
    ov = process_overrides or {}
    pp = ProcessParams1M(
        **{
            name: process_params_for(getattr(processes, name), ov)
            for name in (
                "cloud_liquid_formation",
                "cloud_ice_formation",
                "cloud_ice_melt",
                "rain_autoconversion",
                "snow_autoconversion",
                "rain_condensation_evaporation",
                "snow_deposition_sublimation",
                "snow_melt",
                "cloud_liquid_rain_accretion",
                "cloud_liquid_snow_accretion",
                "cloud_ice_rain_accretion",
                "cloud_ice_snow_accretion",
                "rain_snow_accretion",
            )
        }
    )
    return Microphysics1MParams(
        processes=processes,
        process_params=pp,
        cloud=CloudPhaseParams1M(liquid=CloudLiquid(), ice=cloud_ice()),
        precip=PrecipPhaseParams1M(rain=rain(), snow=snow()),
        air_properties=AirProperties(),
        terminal_velocity=blk1m_vel_type(),
    )
