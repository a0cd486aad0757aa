"""Thermodynamics bridge (L2).

The ~15 functions the reference re-exports from Thermodynamics.jl through
``src/ThermodynamicsInterface.jl``: saturation vapor pressures
(Clausius-Clapeyron with temperature-dependent latent heats), latent heats
(Kirchhoff), moist-air gas constant / heat capacity, vapor specific
content, and supersaturations. All elementwise over tensors.
"""

from __future__ import annotations

import torch

from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import clamp_to_nonneg

__all__ = [
    "latent_heat_vapor",
    "latent_heat_sublim",
    "latent_heat_fusion",
    "saturation_vapor_pressure_over_liquid",
    "saturation_vapor_pressure_over_ice",
    "saturation_vapor_specific_content_over_liquid",
    "saturation_vapor_specific_content_over_ice",
    "supersaturation_over_liquid",
    "supersaturation_over_ice",
    "q_vap",
    "q_vap5",
    "p2q",
    "q2p",
    "gas_constant_air",
    "cp_m",
    "air_density",
    "liquid_fraction",
    "internal_energy_liquid",
    "internal_energy_ice",
]

TPS = ThermodynamicsParameters


def latent_heat_vapor(tps: TPS, T):
    """Kirchhoff's law: ``L_v(T) = LH_v0 + (cp_v - cp_l)(T - T_0)``."""
    return tps.LH_v0 + (tps.cp_v - tps.cp_l) * (T - tps.T_0)


def latent_heat_sublim(tps: TPS, T):
    """``L_s(T) = LH_s0 + (cp_v - cp_i)(T - T_0)``."""
    return tps.LH_s0 + (tps.cp_v - tps.cp_i) * (T - tps.T_0)


def latent_heat_fusion(tps: TPS, T):
    """``L_f(T) = LH_f0 + (cp_l - cp_i)(T - T_0)``."""
    return tps.LH_f0 + (tps.cp_l - tps.cp_i) * (T - tps.T_0)


def _saturation_vapor_pressure(tps: TPS, T, LH_0, delta_cp):
    """Integrated Clausius-Clapeyron with linear-in-T latent heat, written
    as one ``exp`` of ``k log(T/T_triple)`` plus the Clausius exponent."""
    return tps.press_triple * torch.exp(
        (delta_cp / tps.R_v) * torch.log(T / tps.T_triple)
        + (LH_0 - delta_cp * tps.T_0) / tps.R_v * (1 / tps.T_triple - 1 / T)
    )


def saturation_vapor_pressure_over_liquid(tps: TPS, T):
    return _saturation_vapor_pressure(tps, T, tps.LH_v0, tps.cp_v - tps.cp_l)


def saturation_vapor_pressure_over_ice(tps: TPS, T):
    return _saturation_vapor_pressure(tps, T, tps.LH_s0, tps.cp_v - tps.cp_i)


def saturation_vapor_specific_content_over_liquid(tps: TPS, T, rho):
    p_sat = saturation_vapor_pressure_over_liquid(tps, T)
    return p_sat / (rho * tps.R_v * T)


def saturation_vapor_specific_content_over_ice(tps: TPS, T, rho):
    p_sat = saturation_vapor_pressure_over_ice(tps, T)
    return p_sat / (rho * tps.R_v * T)


def q_vap(q_tot, q_liq, q_ice):
    """Vapor specific content, clamped non-negative
    (reference ``src/ThermodynamicsInterface.jl:60``)."""
    return clamp_to_nonneg(q_tot - q_liq - q_ice)


def q_vap5(q_tot, q_lcl, q_icl, q_rai, q_sno):
    """5-argument variant including precipitating species."""
    return clamp_to_nonneg(q_tot - q_lcl - q_icl - q_rai - q_sno)


def p2q(tps: TPS, T, rho, pv):
    """Specific content from partial pressure."""
    return pv / (rho * tps.R_v * T)


def q2p(tps: TPS, T, rho, qv):
    """Partial pressure from specific content."""
    return qv * rho * tps.R_v * T


def supersaturation_over_liquid(tps: TPS, q_tot, q_liq, q_ice, rho, T):
    """``S = p_v / p_sat - 1`` over liquid
    (reference ``src/ThermodynamicsInterface.jl:118-121``)."""
    qv = q_vap(q_tot, q_liq, q_ice)
    p_v = q2p(tps, T, rho, qv)
    return p_v / saturation_vapor_pressure_over_liquid(tps, T) - 1


def supersaturation_over_ice(tps: TPS, q_tot, q_liq, q_ice, rho, T):
    qv = q_vap(q_tot, q_liq, q_ice)
    p_v = q2p(tps, T, rho, qv)
    return p_v / saturation_vapor_pressure_over_ice(tps, T) - 1


def gas_constant_air(tps: TPS, q_tot, q_liq, q_ice):
    """Moist-air gas constant ``R_m``."""
    qv = q_vap(q_tot, q_liq, q_ice)
    return tps.R_d * (1 - q_tot + qv * tps.Rv_over_Rd)


def cp_m(tps: TPS, q_tot, q_liq, q_ice):
    """Moist-air isobaric specific heat."""
    return (
        tps.cp_d
        + (tps.cp_v - tps.cp_d) * q_tot
        + (tps.cp_l - tps.cp_v) * q_liq
        + (tps.cp_i - tps.cp_v) * q_ice
    )


def air_density(tps: TPS, T, p, q_tot, q_liq, q_ice):
    """``rho = p / (R_m T)``."""
    return p / (gas_constant_air(tps, q_tot, q_liq, q_ice) * T)


def liquid_fraction(tps: TPS, T, q_lcl, q_icl):
    """Liquid fraction of condensate; temperature-based when none present."""
    q_c = q_lcl + q_icl
    has_cond = q_c > 0
    q_c_safe = torch.where(has_cond, q_c, torch.ones_like(q_c))
    frac = q_lcl / q_c_safe
    temp_based = torch.where(T > tps.T_freeze, torch.ones_like(frac),
                             torch.zeros_like(frac))
    return torch.where(has_cond, frac, temp_based)


def internal_energy_liquid(tps: TPS, T):
    return tps.cv_l * (T - tps.T_0)


def internal_energy_ice(tps: TPS, T):
    return tps.cv_i * (T - tps.T_0) - tps.LH_f0
