"""Ice nucleation parameters.

Port of ``cloudmicrophysics_tpu/parameters/ice_nucleation.py`` (reference
``src/parameters/IceNucleation.jl``): the same classes, fields and
defaults. :class:`Frostenberg2023` serves the 1M ``TemperatureDependent``
cloud-ice option and the P3 nucleation budgets; :class:`RainFreezing` and
:class:`NIceProxyDepletion` are read by the 2M+P3 tendencies.
"""

from __future__ import annotations

import math

import torch

from ..utils.param import paramclass


@paramclass
class Frostenberg2023:
    """INP concentration distribution vs temperature (Frostenberg et al. 2023,
    doi:10.5194/acp-23-10883-2023; reference
    src/parameters/IceNucleation.jl:178-200).

    At the defaults ``a = b = 1`` the mean log-INPC reduces to the marine
    dataset curve ``log((-T_celsius/10)^9)``.
    """

    sigma: float = 1.37     # standard deviation of log(INPC)
    a: float = 1.0
    b: float = 1.0
    T_freeze: float = 273.15

    @property
    def log_a(self) -> float:
        return math.log(self.a)


@paramclass
class Mohler2006:
    """Deposition nucleation on dust (Mohler et al. 2006;
    reference src/parameters/IceNucleation.jl:13-27)."""

    Si_max: float = 1.35    # max allowed ice saturation ratio
    T_thr: float = 220.0    # threshold temperature [K]


@paramclass
class Koop2000:
    """Homogeneous ice nucleation rate (Koop et al. 2000;
    reference src/parameters/IceNucleation.jl:38-70).
    ``log10 J[cm^-3 s^-1] = c1 + c2 da - c3 da^2 + c4 da^3``."""

    delta_a_w_min: float = 0.26
    delta_a_w_max: float = 0.34
    c1: float = -906.7
    c2: float = 8502.0
    c3: float = 26924.0
    c4: float = 29180.0
    # least-squares fit of log10(J_cubic [cm^-3 s^-1]) over
    # delta_a_w in [0.26, 0.34] step 0.0025 (the reference defines the
    # linear fit this way: docs/src/plots/linear_HOM_J.jl:20-24)
    linear_c1: float = -68.553270833333
    linear_c2: float = 255.9271249999988


@paramclass
class MorrisonMilbrandt2014:
    """P3 deposition (Thompson/Cooper) + heterogeneous condensation
    freezing (Barklie-Gokhale/Bigg) parameters
    (reference src/parameters/IceNucleation.jl:73-106)."""

    T_dep_thres: float = 233.0  # temperature_homogenous_nucleation [K]
    c1: float = 0.005           # Cooper curve [1/L]
    c2: float = 0.304           # [1/K]
    T0: float = 273.15
    het_a: float = 0.65         # [1/K]
    het_B: float = 2e-4 * 1e6   # [1/m^3/s] (2e-4 cm^-3 s^-1)


@paramclass
class RainFreezing:
    """Bigg 1953 immersion freezing (Barklie & Gokhale 1959 coefficients);
    callable volumetric rate ``J = het_B exp(het_a (T0 - T))`` [1/m^3/s]
    (reference src/parameters/IceNucleation.jl:108-176)."""

    het_a: float = 0.65         # [1/K]
    het_B: float = 2e-4 * 1e6   # [1/m^3(water)/s]

    def rate(self, T, T_freeze):
        return self.het_B * torch.exp(self.het_a * (T_freeze - T))


@paramclass
class NIceProxyDepletion:
    """F23 INP-activation memory model: deplete by in-cell ice number."""

    tau_act: float = 300.0  # relaxation timescale [s]


@paramclass
class IceNucleationParameters:
    """Umbrella: deposition (Mohler), homogeneous (Koop), P3 (MM2014)
    (reference src/parameters/IceNucleation.jl)."""

    deposition: Mohler2006
    homogeneous: Koop2000
    p3: MorrisonMilbrandt2014


def ice_nucleation_parameters() -> IceNucleationParameters:
    return IceNucleationParameters(
        deposition=Mohler2006(),
        homogeneous=Koop2000(),
        p3=MorrisonMilbrandt2014(),
    )
