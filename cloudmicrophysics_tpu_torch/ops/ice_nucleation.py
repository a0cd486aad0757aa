"""Heterogeneous ice nucleation: the Frostenberg 2023 and Bigg half.

Port of ``cloudmicrophysics_tpu/ops/ice_nucleation.py:109-216`` (reference
``src/IceNucleation.jl``): the Frostenberg 2023 INP climatology (frequency,
mean, the budgeted deposition and immersion-cap rates, the depletion
proxy) and Bigg immersion freezing integrated over the rain and cloud
PSDs, which the 2M+P3 tendencies read. Mohler 2006, ABIFM/ABDINM, Koop
2000 and the P3 ``N_i`` closures are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..parameters import ice_nucleation as PIN
from ..parameters import m2 as P2
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils import distributions as DT
from ..utils.special import (
    clamp_to_nonneg,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    float_dtype,
    floatmin,
)
from . import m2 as CM2
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = [
    "INP_concentration_frequency",
    "INP_concentration_mean",
    "liquid_freezing_rate_rain",
    "liquid_freezing_rate_cloud",
    "immersion_limit_rate",
    "deposition_rate_frostenberg",
    "n_active",
]


# ---------------------------------------------------------------------------
# Frostenberg 2023 INP climatology (reference src/IceNucleation.jl:219-253)
# ---------------------------------------------------------------------------

def INP_concentration_mean(params: PIN.Frostenberg2023, T):
    """Mean log(INPC) vs T (Frostenberg 2023 Eq 1)."""
    T_celsius = torch.clamp(T - params.T_freeze, max=0.0)
    arg = torch.clamp(-params.b * T_celsius / 10, min=floatmin(T.dtype))
    return 9 * torch.log(arg) - params.log_a


def INP_concentration_frequency(params: PIN.Frostenberg2023, INPC, T):
    """Relative frequency of an INP concentration at temperature T."""
    dt = float_dtype(INPC, T)
    mu = INP_concentration_mean(params, T)
    sig = params.sigma
    INPC_safe = torch.clamp(INPC, min=floatmin(dt))
    freq = torch.exp(-((torch.log(INPC_safe) - mu) ** 2) / (2 * sig**2)) \
        / math.sqrt(PI * 2 * sig**2)
    return torch.where(T >= params.T_freeze, torch.zeros_like(freq), freq)


def immersion_limit_rate(params: PIN.Frostenberg2023, T, rho, tau=300.0,
                         inpc_log_shift=0.0, n_active_proxy=0.0):
    """F23 INPC-budget cap on the immersion freezing number rate
    [1/kg/s] (reference src/IceNucleation.jl:420-430)."""
    log_inpc = INP_concentration_mean(params, T) + inpc_log_shift
    inpc_per_kg = torch.exp(log_inpc) / rho
    rate = clamp_to_nonneg(inpc_per_kg - n_active_proxy) / tau
    return torch.where(T >= params.T_freeze, torch.zeros_like(rate), rate)


def deposition_rate_frostenberg(
    params: PIN.Frostenberg2023, tps: TPS, T, rho, q_tot, q_liq, q_ice,
    n_ice, m_nuc, T_thresh=None, S_i_thresh=0.05, tau_act=300.0,
    inpc_log_shift=0.0,
):
    """F23 deposition nucleation: INPC budget relaxed toward depletion with
    starter-mass and vapor-excess caps
    (reference src/IceNucleation.jl:491-511). Returns (dn_dt, dq_dt)."""
    if T_thresh is None:
        T_thresh = params.T_freeze - 15
    q_sat_ice = TDI.saturation_vapor_specific_content_over_ice(tps, T, rho)
    q_vap = TDI.q_vap(q_tot, q_liq, q_ice)
    S_i = q_vap / q_sat_ice - 1
    cond = (T < T_thresh) & (S_i > S_i_thresh)
    log_inpc = INP_concentration_mean(params, T) + inpc_log_shift
    inpc_per_kg = torch.exp(log_inpc) / rho
    dn_dt = clamp_to_nonneg(inpc_per_kg - n_ice) / tau_act
    dn_dt = torch.where(cond, dn_dt, torch.zeros_like(dn_dt))
    q_excess = clamp_to_nonneg(q_vap - q_sat_ice)
    dq_dt = torch.minimum(m_nuc * dn_dt, q_excess / (2 * tau_act))
    return dn_dt, dq_dt


def n_active(model: PIN.NIceProxyDepletion, n_ice):
    """Depletion proxy for the F23 INPC budget
    (reference src/IceNucleation.jl:526)."""
    return n_ice


# ---------------------------------------------------------------------------
# Bigg immersion freezing over liquid PSDs
# (reference src/IceNucleation.jl:274-388)
# ---------------------------------------------------------------------------

def liquid_freezing_rate_rain(opt: PIN.RainFreezing, pdf_r, tps: TPS,
                              q, rho, N, T):
    """Bigg freezing integrated over the exponential rain PSD. Returns
    ``(dn_frz [1/kg/s], dq_frz [kg/kg/s])``."""
    dt = float_dtype(q, rho, N, T)
    em, en = eps_numerics_2M_M(dt), eps_numerics_2M_N(dt)
    n = N / rho
    Dr_mean = CM2.pdf_rain_parameters(pdf_r, q, rho, N).Dr_mean
    Dm_safe = torch.where(Dr_mean > 0, Dr_mean, torch.ones_like(Dr_mean))
    J_bigg = opt.rate(T, tps.T_freeze)
    M_D3 = DT.exponential_moment(Dm_safe, n, 3)
    M_D6 = DT.exponential_moment(Dm_safe, n, 6)
    M_D3 = torch.where(Dr_mean > 0, M_D3, torch.zeros_like(M_D3))
    M_D6 = torch.where(Dr_mean > 0, M_D6, torch.zeros_like(M_D6))
    V1 = PI / 6
    dn_frz = J_bigg * V1 * M_D3
    dq_frz = J_bigg * pdf_r.rho_w * V1**2 * M_D6
    cond = (n > en) & (q > em) & (T < tps.T_freeze - 4)
    z = torch.zeros_like(dn_frz)
    return torch.where(cond, dn_frz, z), torch.where(cond, dq_frz, z)


def liquid_freezing_rate_cloud(opt: PIN.RainFreezing,
                               pdf_c: P2.CloudParticlePDF_SB2006,
                               tps: TPS, q, rho, N, T):
    """Bigg freezing integrated over the generalized-gamma cloud PSD."""
    dt = float_dtype(q, rho, N, T)
    em, en = eps_numerics_2M_M(dt), eps_numerics_2M_N(dt)
    n = N / rho
    _, lam_c, nuD, muD = CM2.pdf_cloud_parameters(pdf_c, q, rho, N)
    ok = torch.isfinite(lam_c) & (lam_c > 0)
    lam_safe = torch.where(ok, lam_c, torch.ones_like(lam_c))
    J_bigg = opt.rate(T, tps.T_freeze)
    M_D3 = DT.generalized_gamma_moment(nuD, muD, lam_safe, n, 3)
    M_D6 = DT.generalized_gamma_moment(nuD, muD, lam_safe, n, 6)
    M_D3 = torch.where(ok, M_D3, torch.zeros_like(M_D3))
    M_D6 = torch.where(ok, M_D6, torch.zeros_like(M_D6))
    V1 = PI / 6
    dn_frz = J_bigg * V1 * M_D3
    dq_frz = J_bigg * pdf_c.rho_w * V1**2 * M_D6
    cond = (n > en) & (q > em) & (T < tps.T_freeze - 4)
    z = torch.zeros_like(dn_frz)
    return torch.where(cond, dn_frz, z), torch.where(cond, dq_frz, z)
