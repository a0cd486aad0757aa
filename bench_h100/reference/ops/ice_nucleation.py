"""Heterogeneous and homogeneous ice nucleation.

Port of ``cloudmicrophysics_tpu/ops/ice_nucleation.py`` (reference
``src/IceNucleation.jl``): Mohler 2006 dust deposition activation,
water-activity-based deposition (ABDINM) and immersion (ABIFM)
J-coefficients, the P3 deposition and condensation-freezing ``N_i``
closures, the Frostenberg 2023 INP climatology (frequency, mean, the
budgeted deposition and immersion-cap rates, the depletion proxy), Bigg
immersion freezing integrated over the rain and cloud PSDs, and Koop 2000
homogeneous nucleation. A dust struct's numeric fields may be Python
floats or tensors of one value per ensemble member.
"""

from __future__ import annotations

import math

import torch

from ..parameters import ice_nucleation as PIN
from ..parameters import m2 as P2
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils import distributions as DT
from ..utils.special import (
    asarray,
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
    "dust_activated_number_fraction",
    "mohler_deposition_rate",
    "deposition_J",
    "ABIFM_J",
    "P3_deposition_N_i",
    "P3_het_N_i",
    "INP_concentration_frequency",
    "INP_concentration_mean",
    "liquid_freezing_rate_rain",
    "liquid_freezing_rate_cloud",
    "immersion_limit_rate",
    "deposition_rate_frostenberg",
    "n_active",
    "homogeneous_J_cubic",
    "homogeneous_J_linear",
]


def _select(cond, a, b, like):
    """``jnp.where(cond, a, b)`` for two parameter values (Python floats or
    per-member tensors), taken in ``like``'s dtype."""
    return torch.where(cond, asarray(a, like), asarray(b, like))


# ---------------------------------------------------------------------------
# Deposition on dust (Mohler 2006; reference src/IceNucleation.jl:44-77)
# ---------------------------------------------------------------------------

def dust_activated_number_fraction(dust, ip: PIN.Mohler2006, Si, T):
    """Fraction of dust particles acting as deposition nuclei
    (Mohler 2006 Table 2). Valid for ``Si < Si_max``."""
    warm = T > ip.T_thr
    S0 = _select(warm, dust.S0_warm, dust.S0_cold, T)
    a = _select(warm, dust.a_warm, dust.a_cold, T)
    frac = torch.exp(a * (Si - S0)) - 1
    return clamp_to_nonneg(frac)


def mohler_deposition_rate(dust, ip: PIN.Mohler2006, Si, T, dSi_dt, N_aer):
    """Deposition nucleation rate (Mohler 2006 Eq 5) [1/m^3/s]."""
    a = _select(T > ip.T_thr, dust.a_warm, dust.a_cold, T)
    return clamp_to_nonneg(N_aer * a * dSi_dt)


# ---------------------------------------------------------------------------
# Water-activity-based J coefficients
# ---------------------------------------------------------------------------

def deposition_J(dust, delta_a_w):
    """Deposition nucleation rate coefficient J [1/m^2/s] (China et al. 2017;
    reference src/IceNucleation.jl:92-102)."""
    logJ = dust.deposition_m * delta_a_w + dust.deposition_c
    return 10.0 ** (logJ + 4)  # cm^-2 s^-1 -> m^-2 s^-1


def ABIFM_J(dust, delta_a_w):
    """ABIFM immersion freezing J [1/m^2/s] (Knopf & Alpert 2013;
    reference src/IceNucleation.jl:124-134)."""
    logJ = dust.ABIFM_m * delta_a_w + dust.ABIFM_c
    return 10.0 ** (logJ + 4)


# ---------------------------------------------------------------------------
# P3-style nucleation (reference src/IceNucleation.jl:162-205)
# ---------------------------------------------------------------------------

def P3_deposition_N_i(ip: PIN.MorrisonMilbrandt2014, T):
    """Cooper-curve deposition nucleation number [1/m^3]
    (Thompson et al. 2004 Eq 2)."""
    T_p = torch.clamp(T, min=ip.T_dep_thres)
    N_i = 1000.0 * ip.c1 * torch.exp(ip.c2 * (ip.T0 - T_p))
    return torch.where(T < ip.T0, N_i, torch.zeros_like(N_i))


def P3_het_N_i(ip: PIN.MorrisonMilbrandt2014, T, N_l, V_l, dt):
    """Heterogeneous condensation freezing (Pruppacher & Klett Eq 9-51)."""
    T_s = ip.T0 - T
    return N_l * (1 - torch.exp(-ip.het_B * V_l * dt
                                * torch.exp(ip.het_a * T_s)))


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


# ---------------------------------------------------------------------------
# Homogeneous nucleation (Koop 2000; reference src/IceNucleation.jl:543-584)
# ---------------------------------------------------------------------------

def homogeneous_J_cubic(ip: PIN.Koop2000, delta_a_w):
    """Koop 2000 cubic fit: J [1/m^3/s]. Valid for
    ``delta_a_w in [delta_a_w_min, delta_a_w_max]`` (clamped there, as in
    the JAX package; the reference raises a DomainError)."""
    da = torch.clamp(delta_a_w, ip.delta_a_w_min, ip.delta_a_w_max)
    logJ = ip.c1 + ip.c2 * da - ip.c3 * da**2 + ip.c4 * da**3
    return 10.0 ** (logJ + 6)  # cm^-3 s^-1 -> m^-3 s^-1


def homogeneous_J_linear(ip: PIN.Koop2000, delta_a_w):
    """Linear fit of Koop 2000: J [1/m^3/s]."""
    logJ = ip.linear_c2 * delta_a_w + ip.linear_c1
    return 10.0 ** (logJ + 6)
