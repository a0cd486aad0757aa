"""Thermodynamics parameters.

The reference delegates to the external Thermodynamics.jl package through a
thin bridge (reference ``src/ThermodynamicsInterface.jl``). We carry
the same parameter set as a frozen paramclass with the standard ClimaParams
default values, and implement the ~15 bridge functions in
``cloudmicrophysics_tpu.ops.thermo``.
"""

from __future__ import annotations

from ..utils.param import paramclass


@paramclass
class ThermodynamicsParameters:
    """Moist-air thermodynamics constants (ClimaParams defaults)."""

    gas_constant: float = 8.3144598        # universal gas constant [J/mol/K]
    molmass_dryair: float = 0.02897        # [kg/mol]
    molmass_water: float = 0.01801528      # [kg/mol]
    kappa_d: float = 2.0 / 7.0             # adiabatic exponent, dry air
    cp_v: float = 1859.0                   # isobaric specific heat, vapor [J/kg/K]
    cp_l: float = 4181.0                   # liquid [J/kg/K]
    cp_i: float = 2100.0                   # ice [J/kg/K]
    LH_v0: float = 2500800.0               # latent heat vaporization @T_0 [J/kg]
    LH_s0: float = 2834400.0               # latent heat sublimation @T_0 [J/kg]
    T_0: float = 273.16                    # thermodynamic reference temp [K]
    T_triple: float = 273.16               # triple point temperature [K]
    press_triple: float = 611.657          # triple point pressure [Pa]
    T_freeze: float = 273.15               # freezing temperature [K]
    T_icenuc: float = 233.0                # homogeneous nucleation temp [K]
    grav: float = 9.81                     # gravitational acceleration [m/s2]
    q_min: float = 1e-8                    # floor for donor linearization [kg/kg]

    @property
    def R_d(self) -> float:
        return self.gas_constant / self.molmass_dryair

    @property
    def R_v(self) -> float:
        return self.gas_constant / self.molmass_water

    @property
    def Rv_over_Rd(self) -> float:
        return self.molmass_dryair / self.molmass_water

    @property
    def cp_d(self) -> float:
        return self.R_d / self.kappa_d

    @property
    def cv_d(self) -> float:
        return self.cp_d - self.R_d

    @property
    def cv_v(self) -> float:
        return self.cp_v - self.R_v

    @property
    def cv_l(self) -> float:
        return self.cp_l

    @property
    def cv_i(self) -> float:
        return self.cp_i

    @property
    def LH_f0(self) -> float:
        return self.LH_s0 - self.LH_v0
