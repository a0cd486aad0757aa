"""Non-equilibrium cloud condensate formation (relaxation to saturation).

Port of ``cloudmicrophysics_tpu/ops/noneq.py`` (reference
``src/MicrophysicsNonEq.jl``): condensation/evaporation of cloud liquid
and deposition/sublimation of cloud ice with the Morrison-Grabowski Gamma
correction, the INP limiter, the Frostenberg temperature-dependent
deposition timescale, and monodisperse cloud sedimentation velocities.
"""

from __future__ import annotations

import math

import torch

from ..parameters import m1 as P1
from ..parameters.terminal_velocity import (
    Chen2022VelTypeSmallIce,
    StokesRegimeVelType,
)
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import clamp_to_nonneg, eps_numerics, float_dtype
from . import common as CO
from . import thermo as TDI
from .states import MicroState, ThermoState

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = [
    "tau_relax_frostenberg",
    "inp_limiter",
    "dqcld_dT",
    "gamma_helper",
    "conv_q_vap_to_q_lcl",
    "conv_q_vap_to_q_icl",
    "terminal_velocity",
]


def inp_concentration_mean(frostenberg, T):
    """Mean log(INPC) vs temperature (Frostenberg et al. 2023 Eq 1;
    reference src/IceNucleation.jl:250-253)."""
    T_celsius = torch.clamp(T - frostenberg.T_freeze, max=0.0)
    # -b*T_c/10 >= 0; floor before log for the T = T_freeze edge
    arg = torch.clamp(-frostenberg.b * T_celsius / 10,
                      min=torch.finfo(T.dtype).tiny)
    return 9 * torch.log(arg) - frostenberg.log_a


def tau_relax_frostenberg(ice: P1.CloudIce, aps, frostenberg, q_icl, T):
    """Deposition relaxation timescale from the Frostenberg 2023 INP
    parameterization (reference src/MicrophysicsNonEq.jl:32-50)."""
    eps = eps_numerics(float_dtype(q_icl, T))
    N_icl = torch.exp(inp_concentration_mean(frostenberg, T))
    safe_N = torch.clamp(N_icl, min=eps)
    r = torch.where(
        N_icl > eps,
        ((3 * clamp_to_nonneg(q_icl)) / (4 * PI * safe_N * ice.rho_i))
        ** (1.0 / 3.0),
        torch.zeros_like(T),
    )
    r_safe = torch.clamp(r, min=1e-6)
    return 1.0 / (4 * PI * aps.D_vapor * N_icl * r_safe)


def inp_limiter(tendency, tps: TPS, T):
    """True where ice deposition must be suppressed: positive tendency above
    freezing (reference src/MicrophysicsNonEq.jl:58-60)."""
    return (T > tps.T_freeze) & (tendency > 0)


def dqcld_dT(qv_sat, L, Rv, T):
    """d(q_sat)/dT (reference src/MicrophysicsNonEq.jl:74-76)."""
    return qv_sat * (L / (Rv * T**2) - 1 / T)


def gamma_helper(L, cp_air, dq_dT):
    """Thermodynamic adjustment factor Gamma
    (reference src/MicrophysicsNonEq.jl:88-90)."""
    return 1 + (L / cp_air) * dq_dT


def _relaxation_tendency(sat_excess, q_cond, timescale_dep, timescale_sub):
    """Common relaxation form: deposition toward saturation, evaporation
    limited by available condensate."""
    evap = -torch.minimum(-sat_excess, clamp_to_nonneg(q_cond)) / timescale_sub
    dep = sat_excess / timescale_dep
    return torch.where(sat_excess < 0, evap, dep)


def conv_q_vap_to_q_lcl(mp: P1.Microphysics1MParams, tps: TPS,
                        micro: MicroState, thermo: ThermoState):
    """Cloud liquid condensation/evaporation tendency [kg/kg/s]
    (reference src/MicrophysicsNonEq.jl:110-140)."""
    if mp.processes.cloud_liquid_formation is None:
        return torch.zeros_like(thermo.T)
    tau = mp.process_params.cloud_liquid_formation.tau_relax
    rho, T = thermo.rho, thermo.T
    Rv = tps.R_v
    Lv = TDI.latent_heat_vapor(tps, T)
    cp_air = TDI.cp_m(tps, micro.q_tot, micro.q_lcl + micro.q_rai,
                      micro.q_icl + micro.q_sno)
    qv = TDI.q_vap(micro.q_tot, micro.q_lcl + micro.q_rai,
                   micro.q_icl + micro.q_sno)
    qv_sat = TDI.saturation_vapor_specific_content_over_liquid(tps, T, rho)
    Gamma_l = gamma_helper(Lv, cp_air, dqcld_dT(qv_sat, Lv, Rv, T))
    timescale = tau * Gamma_l
    return _relaxation_tendency(qv - qv_sat, micro.q_lcl, timescale, timescale)


def conv_q_vap_to_q_icl(mp: P1.Microphysics1MParams, tps: TPS,
                        micro: MicroState, thermo: ThermoState):
    """Cloud ice deposition/sublimation tendency [kg/kg/s], with the INP
    limiter (no deposition above freezing)
    (reference src/MicrophysicsNonEq.jl:161-224)."""
    opt = mp.processes.cloud_ice_formation
    if opt is None:
        return torch.zeros_like(thermo.T)
    pp = mp.process_params.cloud_ice_formation
    rho, T = thermo.rho, thermo.T
    Rv = tps.R_v
    Ls = TDI.latent_heat_sublim(tps, T)
    cp_air = TDI.cp_m(tps, micro.q_tot, micro.q_lcl + micro.q_rai,
                      micro.q_icl + micro.q_sno)
    qv = TDI.q_vap(micro.q_tot, micro.q_lcl + micro.q_rai,
                   micro.q_icl + micro.q_sno)
    qv_sat = TDI.saturation_vapor_specific_content_over_ice(tps, T, rho)
    Gamma_i = gamma_helper(Ls, cp_air, dqcld_dT(qv_sat, Ls, Rv, T))
    sat_excess = qv - qv_sat

    if opt == P1.CONSTANT_TIMESCALE:
        timescale = pp.tau_relax * Gamma_i
        tendency = _relaxation_tendency(
            sat_excess, micro.q_icl, timescale, timescale)
    elif opt == P1.TEMPERATURE_DEPENDENT:
        tau_dep = tau_relax_frostenberg(
            mp.cloud.ice, mp.air_properties, pp.frostenberg, micro.q_icl, T)
        tendency = _relaxation_tendency(
            sat_excess, micro.q_icl,
            tau_dep * Gamma_i, pp.tau_relax * Gamma_i)
    else:
        raise ValueError(f"unknown cloud ice formation option {opt!r}")

    return torch.where(inp_limiter(tendency, tps, T),
                       torch.zeros_like(tendency), tendency)


def terminal_velocity(sediment, vel, rho_a, q):
    """Monodisperse cloud condensate sedimentation velocity [m/s]
    (reference src/MicrophysicsNonEq.jl:250-281)."""
    dt = float_dtype(rho_a, q)
    eps = eps_numerics(dt)
    safe_q = clamp_to_nonneg(q)
    if isinstance(vel, StokesRegimeVelType):
        prefactor = (1.0 / 18.0) * (vel.rho_w / rho_a - 1) * vel.grav / vel.nu_air
        # D^2 with D = x^(1/3): one exp((2/3) log x)
        log_x = torch.log(6 / PI * rho_a * safe_q / sediment.N_0 / sediment.rho_w)
        fall_w = prefactor * torch.exp((2.0 / 3.0) * log_x)
    elif isinstance(vel, Chen2022VelTypeSmallIce):
        aiu, bi, ciu = CO.chen2022_vel_coeffs_small_ice(
            vel, rho_a, sediment.rho_i)
        # log D computed once and shared with the velocity sum
        log_D = torch.log(
            6 / PI * rho_a * safe_q / sediment.N_0 / sediment.rho_i) / 3.0
        log_D = torch.clamp(log_D, min=math.log(torch.finfo(dt).tiny))
        D = torch.exp(log_D)
        fall_w = clamp_to_nonneg(
            CO.chen2022_velocity_sum(aiu, bi, ciu, D, log_D=log_D))
    else:
        raise TypeError(f"unsupported cloud sedimentation velocity {type(vel)}")
    return torch.where(q > eps, fall_w, torch.zeros_like(fall_w))
