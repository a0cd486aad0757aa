"""2-moment microphysics parameters (Seifert-Beheng 2006 + legacy schemes).

Port of ``cloudmicrophysics_tpu/parameters/m2.py`` (reference
``src/parameters/Microphysics2M.jl``): the same classes, fields, defaults
and factories. Gamma-function coefficients are precomputed on the host in
float64 at construction, as the reference does
(``src/parameters/Microphysics2M.jl:430-431``, ``:590-610``).

``microphysics_2m_params(with_ice=True, **p3_kwargs)`` adds the P3 ice
container of :func:`.p3.p3_ice_params`.
"""

from __future__ import annotations

import math

from ..utils.param import paramclass, static_field


# ---------------------------------------------------------------------------
# Rain / cloud PSDs
# ---------------------------------------------------------------------------

@paramclass
class RainParticlePDF_SB2006:
    """SB2006 rain size distribution (exponential in diameter).

    ``is_limited`` applies the SB2006 Eq 94-97 limiter sequence.
    """

    is_limited: bool = static_field(True)
    nu_r: float = -2.0 / 3.0
    mu_r: float = 1.0 / 3.0
    xr_min: float = 6.54e-11   # [kg] (SB2006_limiters.toml override value)
    xr_max: float = 5e-6       # [kg]
    N0_min: float = 3.5e5      # [1/m^4]
    N0_max: float = 2e10       # [1/m^4]
    lambda_min: float = 1e3    # [1/m]
    lambda_max: float = 4e4    # [1/m]
    rho_w: float = 1000.0
    rho0: float = 1.225


@paramclass
class CloudParticlePDF_SB2006:
    """SB2006 cloud droplet generalized gamma (in mass), nu_c = mu_c = 1
    (reference docs/src/Microphysics2M.md:75)."""

    nu_c: float = 1.0
    mu_c: float = 1.0
    xc_min: float = 4.2e-15    # [kg] (~2 um diameter droplet)
    xc_max: float = 6.54e-11   # [kg] (= raindrop min mass)
    rho_w: float = 1000.0
    loggamma_z1: float = 0.0   # precomputed loggamma((nu+1)/mu)
    loggamma_z2: float = 0.0   # precomputed loggamma((nu+2)/mu)


def cloud_pdf_sb2006(nu_c=1.0, mu_c=1.0, xc_min=4.2e-15, xc_max=6.54e-11,
                     rho_w=1000.0) -> CloudParticlePDF_SB2006:
    z1 = (nu_c + 1) / mu_c
    z2 = (nu_c + 2) / mu_c
    return CloudParticlePDF_SB2006(
        nu_c=nu_c, mu_c=mu_c, xc_min=xc_min, xc_max=xc_max, rho_w=rho_w,
        loggamma_z1=math.lgamma(z1), loggamma_z2=math.lgamma(z2),
    )


# ---------------------------------------------------------------------------
# SB2006 process parameters
# ---------------------------------------------------------------------------

@paramclass
class AcnvSB2006:
    kcc: float = 4.44e9        # [m^3/kg^2/s]
    x_star: float = 6.54e-11   # [kg]
    rho0: float = 1.225
    A: float = 400.0           # phi_au universality coefficients
    a: float = 0.7
    b: float = 3.0


@paramclass
class AccrSB2006:
    kcr: float = 5.25          # [m^3/kg/s]
    tau0: float = 5e-5
    rho0: float = 1.225
    c: float = 4.0


@paramclass
class SelfColSB2006:
    krr: float = 7.12          # [m^3/kg/s]
    kappa_rr: float = 60.7     # [kg^(-1/3)]
    d: float = -5.0


@paramclass
class BreakupSB2006:
    Deq: float = 0.9e-3        # equilibrium mean diameter [m]
    Dr_th: float = 0.35e-3     # breakup threshold diameter [m]
    kbr: float = 1000.0        # [1/m]
    kappa_br: float = 2300.0   # [1/m]


@paramclass
class EvaporationSB2006:
    av: float = 0.78
    bv: float = 0.308
    alpha: float = 159.0       # [m/s kg^-beta]
    beta: float = 0.266
    rho0: float = 1.225
    # precomputed ventilation-moment coefficients
    a_vent_1: float = 0.0      # av / 6^(1/3)
    b_vent_1: float = 0.0      # bv G(5/2 + 3b/2) / 6^(b/2 + 1/2)
    a_vent_0_coeff: float = 0.0  # av 6^(2/3)
    b_vent_0_coeff: float = 0.0  # bv / 6^(b/2 - 1/2)
    beta_vent_0: float = 0.0     # -1/2 + 3b/2


def evaporation_sb2006(av=0.78, bv=0.308, alpha=159.0, beta=0.266,
                       rho0=1.225) -> EvaporationSB2006:
    return EvaporationSB2006(
        av=av, bv=bv, alpha=alpha, beta=beta, rho0=rho0,
        a_vent_1=av / 6 ** (1 / 3),
        b_vent_1=bv * math.gamma(5 / 2 + 3 * beta / 2)
        / 6 ** (beta / 2 + 1 / 2),
        a_vent_0_coeff=av * 6 ** (2 / 3),
        b_vent_0_coeff=bv / 6 ** (beta / 2 - 1 / 2),
        beta_vent_0=-1 / 2 + 3 * beta / 2,
    )


@paramclass
class NumberAdjustmentHorn2012:
    """Number relaxation toward valid mean-particle-mass bounds
    (Horn 2012; tau from docs/src/Microphysics2M.md:893)."""

    tau: float = 100.0         # [s]


@paramclass
class SB2006:
    """Umbrella for the Seifert-Beheng 2006 scheme
    (reference src/parameters/Microphysics2M.jl:614-687)."""

    pdf_c: CloudParticlePDF_SB2006
    pdf_r: RainParticlePDF_SB2006
    acnv: AcnvSB2006
    accr: AccrSB2006
    self_col: SelfColSB2006
    brek: BreakupSB2006
    evap: EvaporationSB2006
    numadj: NumberAdjustmentHorn2012


def sb2006(is_limited: bool = True, **overrides) -> SB2006:
    """Build the SB2006 umbrella; ``overrides`` maps component name
    ("pdf_c", "pdf_r", "acnv", "accr", "self_col", "brek", "evap",
    "numadj") to a dict of keyword overrides for that component's
    constructor (mirrors the reference's TOML-override route,
    src/parameters/toml/SB2006_limiters.toml)."""
    ov = {k: dict(v) for k, v in overrides.items()}
    return SB2006(
        pdf_c=cloud_pdf_sb2006(**ov.get("pdf_c", {})),
        pdf_r=RainParticlePDF_SB2006(is_limited=is_limited,
                                     **ov.get("pdf_r", {})),
        acnv=AcnvSB2006(**ov.get("acnv", {})),
        accr=AccrSB2006(**ov.get("accr", {})),
        self_col=SelfColSB2006(**ov.get("self_col", {})),
        brek=BreakupSB2006(**ov.get("brek", {})),
        evap=evaporation_sb2006(**ov.get("evap", {})),
        numadj=NumberAdjustmentHorn2012(**ov.get("numadj", {})),
    )


@paramclass
class CondEvap2M:
    """2M cloud liquid condensation/evaporation relaxation."""

    tau_relax: float = 10.0


@paramclass
class SubDep2M:
    """2M ice sublimation/deposition relaxation."""

    tau_relax: float = 10.0


# ---------------------------------------------------------------------------
# Legacy double-moment autoconversion / accretion
# ---------------------------------------------------------------------------

@paramclass
class AcnvKK2000:
    A: float = 7.42e13
    a: float = 2.47
    b: float = -1.79
    c: float = -1.47


@paramclass
class AccrKK2000:
    A: float = 67.0
    a: float = 1.15
    b: float = -1.3


@paramclass
class KK2000:
    acnv: AcnvKK2000
    accr: AccrKK2000


def kk2000() -> KK2000:
    return KK2000(acnv=AcnvKK2000(), accr=AccrKK2000())


@paramclass
class AcnvB1994:
    C: float = 3e34
    a: float = -1.7
    b: float = 4.7
    c: float = -3.3
    N_0: float = 2e8          # [1/m^3] regime threshold (200/cm^3)
    d_low: float = 3.9        # used when N_d >= N_0
    d_high: float = 9.9       # used when N_d < N_0
    k: float = 2.0            # smooth-transition steepness


@paramclass
class AccrB1994:
    A: float = 6.0


@paramclass
class B1994:
    acnv: AcnvB1994
    accr: AccrB1994


def b1994() -> B1994:
    return B1994(acnv=AcnvB1994(), accr=AccrB1994())


@paramclass
class AcnvTC1980:
    a: float = 7.0 / 3.0
    b: float = -1.0 / 3.0
    D: float = 3268.0
    r_0: float = 7e-6
    me_liq: float = 3.0
    m0_liq_coeff: float = 1000.0   # = density_liquid_water
    k: float = 2.0


@paramclass
class AccrTC1980:
    A: float = 4.7


@paramclass
class TC1980:
    acnv: AcnvTC1980
    accr: AccrTC1980


def tc1980() -> TC1980:
    return TC1980(acnv=AcnvTC1980(), accr=AccrTC1980())


@paramclass
class LD2004:
    R_6C_0: float = 7.5
    E_0: float = 1.08e10
    rho_w: float = 1000.0
    k: float = 2.0


# ---------------------------------------------------------------------------
# 2M containers (reference src/parameters/Microphysics2MParams.jl)
# ---------------------------------------------------------------------------

@paramclass
class WarmRainParams2M:
    seifert_beheng: SB2006
    air_properties: object
    condevap: CondEvap2M
    subdep: SubDep2M
    # Rain fall-speed parameterization used by the column step:
    # SB2006VelType (Rogers-type) or Chen2022VelTypeRain
    # (reference src/Microphysics2M.jl:685-739 dispatches on this type).
    terminal_velocity: object = None


@paramclass
class Microphysics2MParams:
    """Unified 2M container; ``ice`` (P3IceParams) is optional and added by
    the P3 layer (reference src/parameters/Microphysics2MParams.jl:14-162).
    """

    warm_rain: WarmRainParams2M
    ice: object = None


def microphysics_2m_params(is_limited: bool = True,
                           with_ice: bool = False,
                           rain_velocity: str = "sb2006",
                           **kwargs) -> Microphysics2MParams:
    ice = None
    if with_ice:
        from .p3 import p3_ice_params

        ice = p3_ice_params(**kwargs)
    from .common import AirProperties
    from .terminal_velocity import Chen2022VelTypeRain, SB2006VelType

    if rain_velocity not in ("sb2006", "chen2022"):
        raise ValueError(f"unknown rain_velocity {rain_velocity!r} "
                         "(expected 'sb2006'|'chen2022')")
    vel = (SB2006VelType() if rain_velocity == "sb2006"
           else Chen2022VelTypeRain())
    return Microphysics2MParams(
        warm_rain=WarmRainParams2M(
            seifert_beheng=sb2006(is_limited=is_limited),
            air_properties=AirProperties(),
            condevap=CondEvap2M(),
            subdep=SubDep2M(),
            terminal_velocity=vel,
        ),
        ice=ice,
    )
