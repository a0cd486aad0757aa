"""P3 (predicted particle properties) scheme parameters.

Port of ``cloudmicrophysics_tpu/parameters/p3.py`` (reference
``src/parameters/MicrophysicsP3.jl``): the same classes, fields, defaults
and factories. Values are the published fits: Brown & Francis 1995 mass
law (with the ``10^(6 beta - 3)`` unit conversion applied at construction,
reference ``:38``), Mitchell 1996 area law, Heymsfield 2003 slope power
law, SB2006 ventilation, Cober & List 1993 local rime density.
"""

from __future__ import annotations

import torch

from ..utils.param import paramclass, static_field
from ..utils.quadrature import QuadratureRule, build_quadrature, tabulate


@paramclass
class MassPowerLaw:
    """``m(D) = alpha_va D^beta_va`` (Brown & Francis 1995).

    ``alpha_va`` is stored in SI-like units: the raw BF1995 coefficient
    7.38e-11 [g um^-beta] times ``10^(6 beta - 3)``.
    """

    alpha_va: float = 7.38e-11 * 10 ** (6 * 1.9 - 3)  # = 1.8537e-2
    beta_va: float = 1.9


@paramclass
class AreaPowerLaw:
    """``A(D) = gamma D^sigma`` (Mitchell 1996 aggregates)."""

    gamma: float = 0.2285
    sigma: float = 1.88


@paramclass
class SlopePowerLaw:
    """``mu(lambda) = a lambda^b - c`` clamped to [0, mu_max]
    (Heymsfield 2003, MM2015 Eq 3)."""

    a: float = 0.00191
    b: float = 0.8
    c: float = 2.0
    mu_max: float = 6.0


@paramclass
class SlopeConstant:
    """Constant slope parameter."""

    mu: float = 0.0


@paramclass
class VentilationFactor:
    """``F(D) = a_v + b_v Sc^(1/3) Re(D)^(1/2)`` (SB2006)."""

    av: float = 0.78
    bv: float = 0.308


@paramclass
class LocalRimeDensity:
    """Cober & List 1993 Eq 17 local rime density, linearly extended for
    ``8 < R_i <= 12`` toward solid ice (P3 fortran line 3315-3323)."""

    a: float = 51.0      # [kg/m^3] (0.051 g/cm^3)
    b: float = 114.0     # [kg/m^3]
    c: float = -5.5      # [kg/m^3]
    rho_ice: float = 916.7

    def __call__(self, Ri: torch.Tensor) -> torch.Tensor:
        Ri = torch.clamp(Ri, 1.0, 12.0)
        rho_cl93 = self.a + self.b * Ri + self.c * Ri**2
        rho_8 = self.a + self.b * 8.0 + self.c * 64.0
        f = (Ri - 8.0) / 4.0
        extended = (1 - f) * rho_8 + f * self.rho_ice
        return torch.where(Ri <= 8.0, rho_cl93, extended)


OBLATE = "Oblate"
NO_ASPECT_RATIO = "NoAspectRatio"


@paramclass
class ParametersP3:
    """P3 parameter set (Morrison & Milbrandt 2015;
    reference src/parameters/MicrophysicsP3.jl:286-331)."""

    mass: MassPowerLaw
    area: AreaPowerLaw
    slope: object                  # SlopePowerLaw | SlopeConstant
    vent: VentilationFactor
    rho_rim_local: LocalRimeDensity
    tau_wet: float = 100.0         # wet growth timescale [s]
    rho_i: float = 916.7
    rho_l: float = 1000.0
    T_freeze: float = 273.15
    aspect_ratio: str = static_field(OBLATE)


def parameters_p3(slope_law: str = "powerlaw",
                  aspect_ratio: str = OBLATE, **overrides) -> ParametersP3:
    if slope_law not in ("powerlaw", "constant"):
        raise ValueError(f"unknown slope_law {slope_law!r} "
                         "(expected 'powerlaw'|'constant')")
    slope = SlopePowerLaw() if slope_law == "powerlaw" else SlopeConstant()
    return ParametersP3(
        mass=MassPowerLaw(), area=AreaPowerLaw(), slope=slope,
        vent=VentilationFactor(), rho_rim_local=LocalRimeDensity(),
        aspect_ratio=aspect_ratio, **overrides,
    )


@paramclass
class IceNumberAdjustment:
    """Ice number relaxation toward valid mean-particle-mass bounds.

    Defaults are the reference's inline TODO values
    (src/BulkMicrophysicsTendencies.jl:1058-1062): tau = 100 s,
    x_min ~ 10 um crystal, x_max ~ 5 mm aggregate.
    """

    tau: float = 100.0           # [s]
    x_min: float = 1e-12         # min mean ice particle mass [kg]
    x_max: float = 1e-5          # max mean ice particle mass [kg]


@paramclass
class P3IceParams:
    """2M+P3 ice configuration container
    (reference src/parameters/Microphysics2MParams.jl:55-110)."""

    scheme: ParametersP3
    terminal_velocity: object      # Chen2022VelType
    cloud_pdf: object              # CloudParticlePDF_SB2006
    rain_pdf: object               # RainParticlePDF_SB2006
    ice_nucleation: object         # Frostenberg2023 (empirical INP closure)
    rain_freezing: object          # RainFreezing
    inp_depletion_model: object    # NIceProxyDepletion
    numadj: IceNumberAdjustment = None
    quadrature_order: int = static_field(16)
    quad: QuadratureRule = None    # Tabulated tables of the order's rule

    def __post_init__(self):
        # direct construction (bypassing p3_ice_params) still yields a
        # usable container: fill the derived fields
        if self.numadj is None:
            object.__setattr__(self, "numadj", IceNumberAdjustment())
        if self.quad is None:
            object.__setattr__(
                self, "quad",
                tabulate(build_quadrature(self.quadrature_order)))


def p3_ice_params(quadrature_order: int = 16, slope_law: str = "powerlaw",
                  aspect_ratio: str = OBLATE,
                  ice_nucleation=None) -> P3IceParams:
    from .ice_nucleation import (
        Frostenberg2023,
        NIceProxyDepletion,
        RainFreezing,
    )
    from .m2 import RainParticlePDF_SB2006, cloud_pdf_sb2006
    from .terminal_velocity import chen2022_vel_type

    return P3IceParams(
        scheme=parameters_p3(slope_law=slope_law, aspect_ratio=aspect_ratio),
        terminal_velocity=chen2022_vel_type(),
        cloud_pdf=cloud_pdf_sb2006(),
        rain_pdf=RainParticlePDF_SB2006(),
        # F23 INPC climatology drives both the deposition-nucleation and
        # immersion-cap budgets (reference Microphysics2MParams.jl:65,101)
        ice_nucleation=(Frostenberg2023() if ice_nucleation is None
                        else ice_nucleation),
        rain_freezing=RainFreezing(),
        inp_depletion_model=NIceProxyDepletion(),
        numadj=IceNumberAdjustment(),
        quadrature_order=quadrature_order,
        quad=tabulate(build_quadrature(quadrature_order)),
    )
