"""2-moment microphysics (Seifert-Beheng 2006 + legacy schemes).

Port of ``cloudmicrophysics_tpu/ops/m2.py`` (reference
``src/Microphysics2M.jl``): the SB2006 rain PSD solve (with and without
limiters), the cloud generalized-gamma PSD in log space, autoconversion
with the phi_au universality function, accretion, cloud and rain
self-collection, breakup, terminal velocities, ventilated rain
evaporation, the number adjustment from mass limits, and the legacy
KK2000/B1994/TC1980/LD2004 autoconversion/accretion fits.

All rates are elementwise maps, gated with ``torch.where`` against the
two-tier epsilons (``eps_numerics_2M_M/N``); each expression keeps the
JAX package's operation order, so float32 results round alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parameters import m2 as P2
from ..parameters.common import AirProperties
from ..parameters.terminal_velocity import (
    Chen2022VelTypeRain,
    SB2006VelType,
    StokesRegimeVelType,
)
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils import distributions as DT
from ..utils.special import (
    clamp_to_nonneg,
    eps_numerics,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    float_dtype,
    machine_eps,
)
from . import common as CO
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = [
    "LclRaiRates",
    "RainPDFParams",
    "accretion",
    "accretion_b1994",
    "accretion_kk2000",
    "accretion_tc1980",
    "autoconversion",
    "autoconversion_and_cloud_liquid_self_collection",
    "cloud_liquid_self_collection",
    "cloud_terminal_velocity",
    "conv_q_lcl_to_q_rai_b1994",
    "conv_q_lcl_to_q_rai_kk2000",
    "conv_q_lcl_to_q_rai_ld2004",
    "conv_q_lcl_to_q_rai_tc1980",
    "d_rain_evaporation_d_N_rai_d_q_rai",
    "gamma_incl_approx",
    "log_pdf_cloud_parameters_mass",
    "number_tendency_from_mass_limits",
    "pdf_cloud_parameters",
    "pdf_cloud_parameters_mass",
    "pdf_rain_parameters",
    "pdf_rain_parameters_mass",
    "rain_breakup",
    "rain_evaporation",
    "rain_self_collection",
    "rain_self_collection_and_breakup",
    "rain_terminal_velocity",
    "size_distribution_bounds_cloud",
    "size_distribution_bounds_rain",
    "size_distribution_cloud",
    "size_distribution_rain",
]


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _tiny(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).tiny)


# ---------------------------------------------------------------------------
# Rain PSD parameters (reference src/Microphysics2M.jl:67-110)
# ---------------------------------------------------------------------------

class RainPDFParams(NamedTuple):
    N0r: torch.Tensor       # intercept [1/m^4]
    Dr_mean: torch.Tensor   # mean diameter [m]
    xr_mean: torch.Tensor   # mean mass [kg]


def pdf_rain_parameters(pdf_r: P2.RainParticlePDF_SB2006, q_rai, rho_a,
                        N_rai) -> RainPDFParams:
    """Exponential rain PSD parameters; the limited variant applies the
    SB2006 Eq 94-97 clamp sequence."""
    dt = float_dtype(q_rai, rho_a, N_rai)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q_rai, min=em)
    safe_N = torch.clamp(N_rai, min=en)
    L = rho_a * safe_q

    if pdf_r.is_limited:
        x_t = torch.clamp(L / safe_N, pdf_r.xr_min, pdf_r.xr_max)
        N0 = torch.clamp(safe_N * (PI * pdf_r.rho_w / x_t) ** (1 / 3),
                         pdf_r.N0_min, pdf_r.N0_max)
        lam = torch.clamp(torch.sqrt(torch.sqrt(PI * pdf_r.rho_w * N0 / L)),
                          pdf_r.lambda_min, pdf_r.lambda_max)
        xr_mean = torch.clamp(L * lam / N0, pdf_r.xr_min, pdf_r.xr_max)
        cond = (N_rai < en) & (q_rai < em)
    else:
        xr_mean = L / safe_N
        lam = (PI * pdf_r.rho_w / xr_mean) ** (1 / 3)
        N0 = lam * safe_N
        cond = (N_rai < en) | (q_rai < em)

    Dr_mean = 1 / lam
    z = torch.zeros_like(Dr_mean)
    return RainPDFParams(
        N0r=torch.where(cond, z, N0),
        Dr_mean=torch.where(cond, z, Dr_mean),
        xr_mean=torch.where(cond, z, xr_mean),
    )


def pdf_rain_parameters_mass(pdf_r, q_rai, rho_a, N_rai):
    """Mass-space PSD ``f(x) = A x^(-2/3) exp(-B x^(1/3))``
    (reference src/Microphysics2M.jl:113-146)."""
    xr_mean = pdf_rain_parameters(pdf_r, q_rai, rho_a, N_rai).xr_mean
    Br = (6 / xr_mean) ** (1 / 3)
    Ar = N_rai * Br / 3
    return Ar, Br


# ---------------------------------------------------------------------------
# Cloud PSD parameters (reference src/Microphysics2M.jl:148-236)
# ---------------------------------------------------------------------------

def log_pdf_cloud_parameters_mass(pdf_c: P2.CloudParticlePDF_SB2006, q, rho_a,
                                  N):
    """Log parameters of ``f(x) = A x^nu exp(-B x^mu)`` (SB2006 Eq 79-80)."""
    dt = float_dtype(q, rho_a, N)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q, min=em)
    safe_N = torch.clamp(N, min=en)
    L = rho_a * safe_q
    log_xbar = torch.log(L / safe_N)
    z1 = (pdf_c.nu_c + 1) / pdf_c.mu_c
    logB = -pdf_c.mu_c * (log_xbar + pdf_c.loggamma_z1 - pdf_c.loggamma_z2)
    logA = (torch.log(_const(pdf_c.mu_c, logB)) + torch.log(safe_N)
            + z1 * logB - pdf_c.loggamma_z1)
    cond = (N < en) | (q < em)
    return (torch.where(cond, torch.full_like(logA, -math.inf), logA),
            torch.where(cond, torch.full_like(logB, math.inf), logB))


def pdf_cloud_parameters_mass(pdf_c, q, rho_a, N):
    logA, logB = log_pdf_cloud_parameters_mass(pdf_c, q, rho_a, N)
    return torch.exp(logA), torch.exp(logB)


def pdf_cloud_parameters(pdf_c, q, rho_a, N):
    """Diameter-space generalized gamma
    ``n(D) = N0c D^(3nu+2) exp(-lam_c D^(3mu))``
    (reference src/Microphysics2M.jl:199-236)."""
    logAc, logBc = log_pdf_cloud_parameters_mass(pdf_c, q, rho_a, N)
    k_m = pdf_c.rho_w * PI / 6
    logN0c = logAc + torch.log(_const(3.0, logAc)) \
        + (pdf_c.nu_c + 1) * torch.log(_const(k_m, logAc))
    lam_c = torch.exp(logBc) * k_m**pdf_c.mu_c
    return logN0c, lam_c, 3 * pdf_c.nu_c + 2, 3 * pdf_c.mu_c


def size_distribution_rain(pdf_r, q, rho_a, N, D):
    """Rain ``n(D) = N0r exp(-D/Dr_mean)``."""
    p = pdf_rain_parameters(pdf_r, q, rho_a, N)
    Dm_safe = torch.where(p.Dr_mean > 0, p.Dr_mean, torch.ones_like(p.Dr_mean))
    v = p.N0r * torch.exp(-D / Dm_safe)
    return torch.where(p.N0r == 0, torch.zeros_like(v), v)


def size_distribution_cloud(pdf_c, q, rho_a, N, D):
    """Cloud ``n(D) = exp(logN0c + nuD log D - lam_c D^muD)``."""
    logN0c, lam_c, nuD, muD = pdf_cloud_parameters(pdf_c, q, rho_a, N)
    D_safe = torch.clamp(D, min=_tiny(float_dtype(D)))
    lam_safe = torch.where(torch.isinf(lam_c), torch.zeros_like(lam_c), lam_c)
    v = torch.exp(logN0c + nuD * torch.log(D_safe) - lam_safe * D_safe**muD)
    return torch.where(torch.isneginf(logN0c), torch.zeros_like(v), v)


def size_distribution_bounds_rain(pdf_r, q, rho_a, N, p=None):
    """Quantile bounds of the rain PSD
    (reference src/Microphysics2M.jl:337-355)."""
    dt = float_dtype(q, rho_a, N)
    if p is None:
        p = machine_eps(dt)
    Dr_mean = pdf_rain_parameters(pdf_r, q, rho_a, N).Dr_mean
    Dm_safe = torch.where(Dr_mean > 0, Dr_mean, torch.ones_like(Dr_mean))
    D_min = DT.exponential_quantile(Dm_safe, p)
    D_max = DT.exponential_quantile(Dm_safe, 1 - p)
    z = torch.zeros_like(Dr_mean)
    zero = Dr_mean == 0
    return torch.where(zero, z, D_min), torch.where(zero, z, D_max)


def size_distribution_bounds_cloud(pdf_c, q, rho_a, N, p=None):
    dt = float_dtype(q, rho_a, N)
    if p is None:
        p = machine_eps(dt)
    _, lam_c, nuD, muD = pdf_cloud_parameters(pdf_c, q, rho_a, N)
    p = torch.as_tensor(p, dtype=dt, device=lam_c.device)
    bad = torch.isinf(lam_c) | (lam_c <= 0)
    lam_safe = torch.where(bad, torch.ones_like(lam_c), lam_c)
    # 4 Halley steps: tail-window bounds (see gamma_inc_inv)
    D_min = DT.generalized_gamma_quantile(nuD, muD, lam_safe, p, n_iters=4)
    D_max = DT.generalized_gamma_quantile(nuD, muD, lam_safe, 1 - p,
                                          n_iters=4)
    z = torch.zeros_like(D_min)
    return torch.where(bad, z, D_min), torch.where(bad, z, D_max)


# ---------------------------------------------------------------------------
# Rates (reference src/Microphysics2M.jl:363-601)
# ---------------------------------------------------------------------------

class LclRaiRates(NamedTuple):
    dq_lcl_dt: torch.Tensor
    dN_lcl_dt: torch.Tensor
    dq_rai_dt: torch.Tensor
    dN_rai_dt: torch.Tensor


def autoconversion(acnv: P2.AcnvSB2006, pdf_c: P2.CloudParticlePDF_SB2006,
                   q_lcl, q_rai, rho, N_lcl) -> LclRaiRates:
    """SB2006 Eq 4-6 autoconversion (reference src/Microphysics2M.jl:396-427)."""
    dt = float_dtype(q_lcl, q_rai, rho, N_lcl)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q_lcl = torch.clamp(q_lcl, min=em)
    safe_N_lcl = torch.clamp(N_lcl, min=en)
    L_lcl = rho * safe_q_lcl
    x_lcl = torch.clamp(L_lcl / safe_N_lcl, max=acnv.x_star)
    safe_q_rai = clamp_to_nonneg(q_rai)
    tau = 1 - safe_q_lcl / (safe_q_lcl + safe_q_rai)  # Eq 5
    # tau^a has a vertical tangent at tau = 0; the gate keeps it finite
    tau_safe = torch.clamp(tau, min=em)
    phi_au = torch.where(
        q_rai < em, torch.zeros_like(tau),
        acnv.A * tau_safe**acnv.a * (1 - tau_safe**acnv.a) ** acnv.b)

    nu = pdf_c.nu_c
    dL_rai_dt = (
        acnv.kcc / 20 / acnv.x_star * (nu + 2) * (nu + 4) / (nu + 1) ** 2
        * L_lcl**2 * x_lcl**2 * (1 + phi_au / (1 - tau) ** 2)
        * acnv.rho0 / rho
    )  # Eq 4
    dN_rai_dt = dL_rai_dt / acnv.x_star
    cond = (q_lcl < em) | (N_lcl < en)
    z = torch.zeros_like(dL_rai_dt)
    return LclRaiRates(
        dq_lcl_dt=torch.where(cond, z, -dL_rai_dt / rho),
        dN_lcl_dt=torch.where(cond, z, -2 * dN_rai_dt),
        dq_rai_dt=torch.where(cond, z, dL_rai_dt / rho),
        dN_rai_dt=torch.where(cond, z, dN_rai_dt),
    )


def accretion(sb: P2.SB2006, q_lcl, q_rai, rho, N_lcl) -> LclRaiRates:
    """SB2006 Eq 7-8 accretion (reference src/Microphysics2M.jl:445-470)."""
    dt = float_dtype(q_lcl, q_rai, rho, N_lcl)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    accr = sb.accr
    safe_q_lcl = torch.clamp(q_lcl, min=em)
    safe_q_rai = torch.clamp(q_rai, min=em)
    safe_N_lcl = torch.clamp(N_lcl, min=en)
    L_lcl = rho * safe_q_lcl
    L_rai = rho * safe_q_rai
    x_lcl = L_lcl / safe_N_lcl
    tau = 1 - safe_q_lcl / (safe_q_lcl + safe_q_rai)
    phi_ac = (tau / (tau + accr.tau0)) ** accr.c
    dL_rai_dt = accr.kcr * L_lcl * L_rai * phi_ac * torch.sqrt(accr.rho0 / rho)
    dL_lcl_dt = -dL_rai_dt
    dN_lcl_dt = dL_lcl_dt / x_lcl
    cond = (q_lcl < em) | (q_rai < em) | (N_lcl < en)
    z = torch.zeros_like(dL_rai_dt)
    return LclRaiRates(
        dq_lcl_dt=torch.where(cond, z, dL_lcl_dt / rho),
        dN_lcl_dt=torch.where(cond, z, dN_lcl_dt),
        dq_rai_dt=torch.where(cond, z, dL_rai_dt / rho),
        dN_rai_dt=z,
    )


def cloud_liquid_self_collection(acnv: P2.AcnvSB2006, pdf_c, q_lcl, rho,
                                 dN_lcl_dt_au):
    """SB2006 Eq 9 (reference src/Microphysics2M.jl:488-501)."""
    em = eps_numerics_2M_M(float_dtype(q_lcl, rho))
    L_lcl = rho * q_lcl
    nu = pdf_c.nu_c
    rate = (-acnv.kcc * (nu + 2) / (nu + 1) * (acnv.rho0 / rho) * L_lcl**2
            - dN_lcl_dt_au)
    return torch.where(q_lcl < em, torch.zeros_like(rate), rate)


def autoconversion_and_cloud_liquid_self_collection(sb: P2.SB2006, q_lcl,
                                                    q_rai, rho, N_lcl):
    au = autoconversion(sb.acnv, sb.pdf_c, q_lcl, q_rai, rho, N_lcl)
    sc = cloud_liquid_self_collection(sb.acnv, sb.pdf_c, q_lcl, rho,
                                      au.dN_lcl_dt)
    return au, sc


def rain_self_collection(pdf_r, self_col: P2.SelfColSB2006, q_rai, rho,
                         N_rai):
    """SB2006 Eq 11 (reference src/Microphysics2M.jl:521-544)."""
    dt = float_dtype(q_rai, rho, N_rai)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q_rai, min=em)
    safe_N = torch.clamp(N_rai, min=en)
    L_rai = rho * safe_q
    _, Br = pdf_rain_parameters_mass(pdf_r, safe_q, rho, safe_N)
    rate = (-self_col.krr * N_rai * L_rai * torch.sqrt(pdf_r.rho0 / rho)
            * (1 + self_col.kappa_rr / Br) ** self_col.d)
    cond = (q_rai < em) | (N_rai < en)
    return torch.where(cond, torch.zeros_like(rate), rate)


def rain_breakup(pdf_r, brek: P2.BreakupSB2006, q_rai, rho, N_rai,
                 dN_rai_dt_sc):
    """SB2006 Eq 13 (reference src/Microphysics2M.jl:579-601)."""
    dt = float_dtype(q_rai, rho, N_rai)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q_rai, min=em)
    safe_N = torch.clamp(N_rai, min=en)
    xr_mean = pdf_rain_parameters(pdf_r, safe_q, rho, safe_N).xr_mean
    Dr = (torch.clamp(xr_mean, min=_tiny(dt))
          * 6 / (PI * pdf_r.rho_w)) ** (1 / 3)
    dD = Dr - brek.Deq
    phi_br = torch.where(
        Dr < brek.Dr_th, torch.full_like(Dr, -1.0),
        torch.where(Dr <= brek.Deq, brek.kbr * dD,
                    torch.exp(brek.kappa_br * dD) - 1))
    rate = -(phi_br + 1) * dN_rai_dt_sc
    cond = (q_rai < em) | (N_rai < en)
    return torch.where(cond, torch.zeros_like(rate), rate)


def rain_self_collection_and_breakup(sb: P2.SB2006, q_rai, rho, N_rai):
    sc = rain_self_collection(sb.pdf_r, sb.self_col, q_rai, rho, N_rai)
    br = rain_breakup(sb.pdf_r, sb.brek, q_rai, rho, N_rai, sc)
    return sc, br


# ---------------------------------------------------------------------------
# Terminal velocities (reference src/Microphysics2M.jl:625-753)
# ---------------------------------------------------------------------------

def cloud_terminal_velocity(pdf_c, vel: StokesRegimeVelType, q_liq, rho_a,
                            N_liq):
    """Number- and mass-weighted Stokes-regime cloud droplet velocities via
    gamma moments (reference src/Microphysics2M.jl:647-664)."""
    dt = float_dtype(q_liq, rho_a, N_liq)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q_liq, min=em)
    safe_N = torch.clamp(N_liq, min=en)
    _, Bc = pdf_cloud_parameters_mass(pdf_c, safe_q, rho_a, safe_N)
    pref = ((1.0 / 18.0) * (6 / vel.rho_w / PI) ** (2 / 3)
            * (vel.rho_w / rho_a - 1) * vel.grav / vel.nu_air)
    nu, mu = pdf_c.nu_c, pdf_c.mu_c
    vt0 = pref * DT.generalized_gamma_moment(nu, mu, Bc, safe_N, 2 / 3) / safe_N
    vt1 = pref * DT.generalized_gamma_moment(nu, mu, Bc, safe_N, 5 / 3) \
        / rho_a / safe_q
    cond = (N_liq < en) | (q_liq < em)
    z = torch.zeros_like(vt0)
    return torch.where(cond, z, vt0), torch.where(cond, z, vt1)


def _sb_vel_helper(pdf_r, lam_r, aR, bR, cR):
    """Positive-velocity integration bounds helper for the not-limited PSD
    (reference src/Microphysics2M.jl:843-863)."""
    if pdf_r.is_limited:
        one = torch.ones_like(lam_r)
        return one, one, one, one
    rc = -1 / (2 * cR) * math.log(aR / bR)

    def G1(t):
        return torch.exp(-t)

    def G4(t):
        return (t**3 + 3 * t**2 + 6 * t + 6) * torch.exp(-t)

    pa0 = G1(2 * rc * lam_r)
    pb0 = G1(2 * rc * (lam_r + cR))
    pa1 = G4(2 * rc * lam_r) / 6
    pb1 = G4(2 * rc * (lam_r + cR)) / 6
    return pa0, pb0, pa1, pb1


def rain_terminal_velocity(sb: P2.SB2006, vel, q_rai, rho, N_rai):
    """Number- and mass-weighted rain fall velocities; Rogers-type
    (SB2006VelType) or Chen2022 (reference src/Microphysics2M.jl:685-739)."""
    dt = float_dtype(q_rai, rho, N_rai)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    safe_q = torch.clamp(q_rai, min=em)
    safe_N = torch.clamp(N_rai, min=en)
    pdf_r = sb.pdf_r
    Dr_mean = pdf_rain_parameters(pdf_r, safe_q, rho, safe_N).Dr_mean

    if isinstance(vel, SB2006VelType):
        lam_r = 1 / Dr_mean
        pa0, pb0, pa1, pb1 = _sb_vel_helper(pdf_r, lam_r, vel.aR, vel.bR,
                                            vel.cR)
        sq = torch.sqrt(vel.rho0 / rho)
        vt0 = clamp_to_nonneg(
            sq * (vel.aR * pa0 - vel.bR * pb0 / (1 + vel.cR * Dr_mean)))
        vt1 = clamp_to_nonneg(
            sq * (vel.aR * pa1 - vel.bR * pb1 / (1 + vel.cR * Dr_mean) ** 4))
    elif isinstance(vel, Chen2022VelTypeRain):
        aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(vel, rho)
        vt0 = clamp_to_nonneg(sum(
            CO.chen2022_exponential_pdf(a, b, c, Dr_mean, 0)
            for a, b, c in zip(aiu, bi, ciu)))
        vt1 = clamp_to_nonneg(sum(
            CO.chen2022_exponential_pdf(a, b, c, Dr_mean, 3)
            for a, b, c in zip(aiu, bi, ciu)))
    else:
        raise TypeError(f"unsupported rain velocity type {type(vel)}")

    z = torch.zeros_like(vt0)
    return (torch.where(N_rai < en, z, vt0), torch.where(q_rai < em, z, vt1))


# ---------------------------------------------------------------------------
# Rain evaporation (reference src/Microphysics2M.jl:746-853)
# ---------------------------------------------------------------------------

def gamma_incl_approx(a, x):
    """Approximate upper incomplete gamma for a in {-1, -0.101},
    x in [0.067, 1.82] (reference src/Microphysics2M.jl:746-753)."""
    return torch.exp(-x) / (
        (0.33 - 0.7 * a) * x ** (0.08 - 0.93 * a)
        + (1.34 - 0.1 * a) * x ** (0.8 - a)
    )


def rain_evaporation(sb: P2.SB2006, aps: AirProperties, tps: TPS,
                     q_tot, q_lcl, q_icl, q_rai, q_sno, rho, N_rai, T):
    """Ventilated rain evaporation of number and mass
    (reference src/Microphysics2M.jl:780-828). Returns
    ``(dn_rai_dt [1/m^3/s], dq_rai_dt [kg/kg/s])``, both <= 0."""
    dt = float_dtype(q_tot, rho, N_rai, T)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    evap = sb.evap
    pdf_r = sb.pdf_r

    S = TDI.supersaturation_over_liquid(
        tps, q_tot, q_lcl + q_rai, q_icl + q_sno, rho, T)
    G = CO.G_func_liquid(aps, tps, T)
    x_star = pdf_r.xr_min

    safe_q = torch.clamp(q_rai, min=em)
    safe_N = torch.clamp(N_rai, min=en)
    xr_mean = pdf_rain_parameters(pdf_r, safe_q, rho, safe_N).xr_mean
    xr_safe = torch.clamp(xr_mean, min=_tiny(dt))
    Dr = (6 * xr_safe / (PI * pdf_r.rho_w)) ** (1 / 3)

    t_star = (6 * x_star / xr_safe) ** (1 / 3)
    a_vent_0 = evap.a_vent_0_coeff * gamma_incl_approx(-1.0, t_star)
    b_vent_0 = evap.b_vent_0_coeff * gamma_incl_approx(evap.beta_vent_0,
                                                       t_star)

    N_Re = evap.alpha * xr_safe**evap.beta * torch.sqrt(evap.rho0 / rho) \
        * Dr / aps.nu_air
    cbrt_Sc = (aps.nu_air / max(aps.D_vapor, eps_numerics(dt))) ** (1 / 3)
    sqrt_N_Re = torch.sqrt(N_Re)
    Fv0 = a_vent_0 + b_vent_0 * cbrt_Sc * sqrt_N_Re
    Fv1 = evap.a_vent_1 + evap.b_vent_1 * cbrt_Sc * sqrt_N_Re

    dn_rai_dt = torch.clamp(2 * PI * G * S * N_rai * Dr * Fv0 / xr_safe,
                            max=0.0)
    dq_rai_dt = torch.clamp(2 * PI * G * S * N_rai * Dr * Fv1 / rho, max=0.0)

    z = torch.zeros_like(S)
    eps_ = machine_eps(dt)
    dn_rai_dt = torch.where(
        (q_rai < em) | (xr_mean / x_star < eps_) | (N_rai <= en) | (S >= 0),
        z, dn_rai_dt)
    dq_rai_dt = torch.where((q_rai < em) | (N_rai <= en) | (S >= 0),
                            z, dq_rai_dt)
    return dn_rai_dt, dq_rai_dt


def d_rain_evaporation_d_N_rai_d_q_rai(sb, aps, tps, q_tot, q_lcl, q_icl,
                                       q_rai, q_sno, rho, N_rai, T):
    """Leading-order derivatives of the evaporation tendencies
    (reference src/Microphysics2M.jl:844-853)."""
    dt = float_dtype(q_tot)
    dn, dq = rain_evaporation(sb, aps, tps, q_tot, q_lcl, q_icl, q_rai,
                              q_sno, rho, N_rai, T)
    en = eps_numerics_2M_N(dt)
    em = eps_numerics_2M_M(dt)
    dN = torch.where(N_rai > en, dn / torch.clamp(N_rai, min=en),
                     torch.zeros_like(dn))
    dq_ = torch.where(q_rai > em, dq / torch.clamp(q_rai, min=em),
                      torch.zeros_like(dq))
    return dN, dq_


def number_tendency_from_mass_limits(x_min, x_max, tau, q, n):
    """Relax specific number so the mean particle mass stays in
    ``[x_min, x_max]`` (Horn 2012; reference src/Microphysics2M.jl:882-891)."""
    em = eps_numerics_2M_M(float_dtype(q, n))
    n_target = torch.where(
        q < em, torch.zeros_like(n), torch.clamp(n, q / x_max, q / x_min))
    return (n_target - n) / tau


# ---------------------------------------------------------------------------
# Legacy autoconversion / accretion (reference src/Microphysics2M.jl:920-1002)
# ---------------------------------------------------------------------------

def conv_q_lcl_to_q_rai_kk2000(params: P2.KK2000, q_lcl, rho, N_d):
    q_lcl = clamp_to_nonneg(q_lcl)
    a = params.acnv
    dt = float_dtype(q_lcl, rho, N_d)
    q_safe = torch.clamp(q_lcl, min=_tiny(dt))
    rate = a.A * q_safe**a.a * N_d**a.b * rho**a.c
    return torch.where(q_lcl > 0, rate, torch.zeros_like(rate))


def conv_q_lcl_to_q_rai_b1994(params: P2.B1994, q_lcl, rho, N_d,
                              smooth_transition=False):
    q_lcl = clamp_to_nonneg(q_lcl)
    a = params.acnv
    if smooth_transition:
        frac_low = CO.logistic_function(N_d, a.N_0, a.k)
        d = frac_low * a.d_low + (1 - frac_low) * a.d_high
    else:
        d = torch.where(N_d >= a.N_0, torch.full_like(N_d, a.d_low),
                        torch.full_like(N_d, a.d_high))
    dt = float_dtype(q_lcl, rho, N_d)
    q_safe = torch.clamp(q_lcl * rho, min=_tiny(dt))
    rate = a.C * d**a.a * q_safe**a.b * N_d**a.c / rho
    return torch.where(q_lcl > 0, rate, torch.zeros_like(rate))


def conv_q_lcl_to_q_rai_tc1980(params: P2.TC1980, q_lcl, rho, N_d,
                               smooth_transition=False):
    q_lcl = clamp_to_nonneg(q_lcl)
    a = params.acnv
    q_threshold = a.m0_liq_coeff * N_d / rho * a.r_0**a.me_liq
    if smooth_transition:
        output = CO.logistic_function(q_lcl, q_threshold, a.k)
    else:
        output = CO.heaviside(q_lcl - q_threshold)
    dt = float_dtype(q_lcl, rho, N_d)
    q_safe = torch.clamp(q_lcl, min=_tiny(dt))
    rate = a.D * q_safe**a.a * N_d**a.b * output
    return torch.where(q_lcl > 0, rate, torch.zeros_like(rate))


def conv_q_lcl_to_q_rai_ld2004(params: P2.LD2004, q_lcl, rho, N_d,
                               smooth_transition=False):
    em = eps_numerics_2M_M(float_dtype(q_lcl, rho, N_d))
    q_safe = torch.clamp(q_lcl, min=em)
    r_vol = ((3 * q_safe * rho / (4 * PI * params.rho_w * N_d)) ** (1 / 3)
             * 1e6)
    beta_6 = ((r_vol + 3) / r_vol) ** (1 / 3)
    E = params.E_0 * beta_6**6
    R_6 = beta_6 * r_vol
    R_6C = params.R_6C_0 / (q_safe * rho) ** (1 / 6) / torch.sqrt(R_6)
    if smooth_transition:
        output = CO.logistic_function(R_6, R_6C, params.k)
    else:
        output = CO.heaviside(R_6 - R_6C)
    rate = E * (q_safe * rho) ** 3 / N_d / rho * output
    return torch.where(q_lcl <= em, torch.zeros_like(rate), rate)


def accretion_kk2000(params: P2.KK2000, q_lcl, q_rai, rho):
    q_lcl = clamp_to_nonneg(q_lcl)
    q_rai = clamp_to_nonneg(q_rai)
    a = params.accr
    dt = float_dtype(q_lcl, rho)
    prod = torch.clamp(q_lcl * q_rai, min=_tiny(dt))
    rate = a.A * prod**a.a * rho**a.b
    return torch.where((q_lcl > 0) & (q_rai > 0), rate, torch.zeros_like(rate))


def accretion_b1994(params: P2.B1994, q_lcl, q_rai, rho):
    q_lcl = clamp_to_nonneg(q_lcl)
    q_rai = clamp_to_nonneg(q_rai)
    return params.accr.A * q_lcl * rho * q_rai


def accretion_tc1980(params: P2.TC1980, q_lcl, q_rai):
    q_lcl = clamp_to_nonneg(q_lcl)
    q_rai = clamp_to_nonneg(q_rai)
    return params.accr.A * q_lcl * q_rai
