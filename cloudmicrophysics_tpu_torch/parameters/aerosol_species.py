"""Aerosol species parameters (12 species).

Port of ``cloudmicrophysics_tpu/parameters/aerosol_species.py`` (reference
``src/parameters/Aerosol*.jl``): the same classes, fields and defaults. Each species
carries chemistry for ARG/kappa activation and, for dusts, the
ABIFM immersion (Knopf & Alpert 2013) and ABDINM deposition (China et al.
2017) J-coefficients plus Mohler 2006 thresholds where applicable.

Values are the ClimaParams registry defaults (literature fits); the
ABIFM/ABDINM coefficients are validated against the published-figure
comparisons in ``test/heterogeneous_ice_nucleation_tests.jl``.
"""

from __future__ import annotations

from ..utils.param import paramclass


@paramclass
class Seasalt:
    M: float = 0.058443      # molar mass [kg/mol] (NaCl)
    rho: float = 2170.0      # density [kg/m^3]
    phi: float = 0.9         # osmotic coefficient
    nu: float = 2.0          # ion number
    epsilon: float = 1.0     # soluble mass fraction
    kappa: float = 1.12      # hygroscopicity


@paramclass
class Sulfate:
    M: float = 0.13214       # ammonium sulfate [kg/mol]
    rho: float = 1770.0
    phi: float = 1.0
    nu: float = 3.0
    epsilon: float = 1.0
    kappa: float = 0.53


@paramclass
class ArizonaTestDust:
    """Mohler 2006 deposition thresholds (Table 2) + ABIFM/ABDINM
    J-coefficients."""

    S0_warm: float = 1.3     # S_i threshold, T > T_thr (220 K)
    S0_cold: float = 1.1     # T < T_thr
    a_warm: float = 2.0      # activated-fraction steepness
    a_cold: float = 5.0
    deposition_m: float = 47.8
    deposition_c: float = -7.7
    ABIFM_m: float = 37.3
    ABIFM_c: float = -5.54


@paramclass
class DesertDust:
    """Saharan desert dust (Mohler 2006 Table 2 + Knopf-Alpert 2013)."""

    S0_warm: float = 1.2
    S0_cold: float = 1.05
    a_warm: float = 2.0
    a_cold: float = 4.7
    deposition_m: float = 5.8
    deposition_c: float = 0.91
    ABIFM_m: float = 22.62
    ABIFM_c: float = -1.35


@paramclass
class Illite:
    deposition_m: float = 4.3
    deposition_c: float = 2.04
    ABIFM_m: float = 54.48
    ABIFM_c: float = -10.67


@paramclass
class Kaolinite:
    deposition_m: float = 4.7
    deposition_c: float = 1.52
    ABIFM_m: float = 53.88
    ABIFM_c: float = -10.54


@paramclass
class Feldspar:
    deposition_m: float = 20.62
    deposition_c: float = -1.69
    ABIFM_m: float = 0.0
    ABIFM_c: float = 0.0


@paramclass
class Ferrihydrite:
    deposition_m: float = 28.75
    deposition_c: float = -2.92
    ABIFM_m: float = 0.0
    ABIFM_c: float = 0.0


@paramclass
class AsianDust:
    deposition_m: float = 23.0
    deposition_c: float = -1.1
    ABIFM_m: float = 23.0
    ABIFM_c: float = -1.1


@paramclass
class MiddleEasternDust:
    deposition_m: float = 23.0
    deposition_c: float = -1.1
    ABIFM_m: float = 23.0
    ABIFM_c: float = -1.1


@paramclass
class SaharanDust:
    deposition_m: float = 23.0
    deposition_c: float = -1.1
    ABIFM_m: float = 23.0
    ABIFM_c: float = -1.1


@paramclass
class Dust:
    """Generic dust."""

    deposition_m: float = 23.0
    deposition_c: float = -1.1
    ABIFM_m: float = 23.0
    ABIFM_c: float = -1.1


@paramclass
class H2SO4SolutionParameters:
    """Sulphuric acid solution vapor pressure fit (Luo et al. 1995;
    reference src/parameters/Aerosol_H2SO4_Solution.jl)."""

    T_max: float = 235.0
    T_min: float = 185.0
    w_2: float = 1.4408
    c1: float = 23.306
    c2: float = 5.3465
    c3: float = 12.0
    c4: float = 8.19
    c5: float = -5814.0
    c6: float = 928.9
    c7: float = 1876.7
