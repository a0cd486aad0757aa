"""1-moment bulk microphysics (Marshall-Palmer rain/snow/cloud-ice).

Port of ``cloudmicrophysics_tpu/ops/m1.py`` (reference
``src/Microphysics1M.jl``): terminal velocities (power-law and Chen
2022), autoconversion, the four accretion pairs + rain sink + two-sided
rain-snow collisions with a velocity-dispersion kernel, rain evaporation,
snow sublimation/deposition, cloud ice melt, and snow melt.

* Every rate is an elementwise map over ``(MicroState, ThermoState)``
  tensors, gated branchlessly with ``torch.where``.
* Process variants are selected by the option strings on
  ``Microphysics1MParams.processes`` (Python-level dispatch).
* :func:`size_distr_parameters` is the reference's compute-once pattern
  (``src/Microphysics1M.jl:375-388``): the PSD parameters of each species
  are computed once per cell, in shared log space, and threaded through
  all process rates, so each fractional power ``(lambda_inv/r0)**p`` is
  one ``exp``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parameters import m1 as P1
from ..parameters.terminal_velocity import (
    Blk1MVelTypeRain,
    Blk1MVelTypeSnow,
    Chen2022VelTypeLargeIce,
    Chen2022VelTypeRain,
)
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import clamp_to_nonneg, eps_numerics, float_dtype
from . import common as CO
from . import thermo as TDI
from .states import MicroState, ThermoState

TPS = ThermodynamicsParameters
PI = math.pi

OBLATE = "Oblate"
PROLATE = "Prolate"


def _tiny(dt: torch.dtype) -> float:
    """Floor on q and rho before a log: keeps float32 intermediates out of
    the subnormal range."""
    return 1e-50 if dt == torch.float64 else 1e-25


# ---------------------------------------------------------------------------
# Size-distribution parameters (reference src/Microphysics1M.jl:83-152)
# ---------------------------------------------------------------------------

def get_n0(pdf, q=None, rho=None):
    """Marshall-Palmer intercept parameter.

    Snow: ``n0 = mu (rho q_sno)^nu`` gated on presence; rain/ice: fixed
    (reference ``src/Microphysics1M.jl:83-87``).
    """
    if isinstance(pdf, P1.ParticlePDFSnow):
        eps = eps_numerics(float_dtype(q, rho))
        safe_q = torch.clamp(q, min=eps)
        n0 = pdf.mu * (rho * safe_q) ** pdf.nu
        return torch.where(q > eps, n0, torch.zeros_like(n0))
    return pdf.n0


def get_v0(vel, rho=None):
    """Terminal-velocity proportionality coefficient
    (reference ``src/Microphysics1M.jl:90-107``)."""
    if isinstance(vel, Blk1MVelTypeRain):
        density_factor = clamp_to_nonneg(vel.rho_w / rho - 1)
        return torch.sqrt(
            (8.0 / 3.0) / vel.C_drag * density_factor * vel.grav * vel.r0
        )
    return vel.v0


def lambda_inverse(pdf, mass: P1.ParticleMass, q, rho):
    """Inverse rate parameter of the Marshall-Palmer distribution [m],
    floored at ``r0 * 1e-5`` (reference ``src/Microphysics1M.jl:126-152``),
    computed in log space with a small floor on q."""
    dt = float_dtype(q, rho)
    eps = eps_numerics(dt)
    n0 = get_n0(pdf, q, rho)
    tiny = _tiny(dt)
    qp = torch.clamp(clamp_to_nonneg(q), min=tiny)
    rhop = torch.clamp(clamp_to_nonneg(rho), min=tiny)
    if isinstance(n0, torch.Tensor):
        log_n0 = torch.log(torch.clamp(n0, min=eps))
    else:
        log_n0 = math.log(max(n0, eps))
    log_denom = math.log(mass.chim * mass.m0 * mass.gamma_coeff) + log_n0
    power = 1.0 / (mass.me + mass.dm + 1)
    log_num = (
        torch.log(rhop) + torch.log(qp)
        + math.log(mass.r0) * (mass.me + mass.dm)
    )
    lam_inv = torch.exp(power * (log_num - log_denom))
    # below the q floor the ratio is meaningless (snow n0 -> 0 faster than
    # q); select 0 so the r0*1e-5 floor wins
    lam_inv = torch.where(q > tiny, lam_inv, torch.zeros_like(lam_inv))
    return torch.clamp(lam_inv, min=mass.r0 * 1e-5)


class SizeDistParams(NamedTuple):
    """Per-cell PSD parameters, computed once (compute-once pattern).

    The ``log_lambda_inv_*`` fields carry ``log(lambda_inv)`` (floored,
    identical to ``log`` of the value field) so every downstream fractional
    power ``(lambda_inv/r0)**p`` is a single ``exp``. ``None`` when
    constructed by hand (all rate functions then use ``pow`` on the value
    field). ``n0_rai``/``n0_icl``/``v0_sno`` are Python floats."""

    lambda_inv_rai: torch.Tensor
    n0_rai: float
    v0_rai: torch.Tensor
    lambda_inv_sno: torch.Tensor
    n0_sno: torch.Tensor
    v0_sno: float
    lambda_inv_icl: torch.Tensor
    n0_icl: float
    log_lambda_inv_rai: Optional[torch.Tensor] = None
    log_lambda_inv_sno: Optional[torch.Tensor] = None
    log_lambda_inv_icl: Optional[torch.Tensor] = None


def _log_lambda_inverse(mass: P1.ParticleMass, q, log_q, log_rho, log_n0):
    """``log`` of :func:`lambda_inverse` (floored), sharing precomputed
    logs of q, rho and n0."""
    dt = float_dtype(q, log_rho)
    tiny = _tiny(dt)
    power = 1.0 / (mass.me + mass.dm + 1)
    log_denom = math.log(mass.chim * mass.m0 * mass.gamma_coeff) + log_n0
    log_num = log_q + log_rho + math.log(mass.r0) * (mass.me + mass.dm)
    log_lam = power * (log_num - log_denom)
    # below the q floor the ratio is meaningless; push to -big so the
    # r0*1e-5 floor wins
    log_lam = torch.where(q > tiny, log_lam,
                          torch.full_like(log_lam, torch.finfo(dt).min / 2))
    return torch.clamp(log_lam, min=math.log(mass.r0 * 1e-5))


def size_distr_parameters(
    mp: P1.Microphysics1MParams, micro: MicroState, thermo: ThermoState
) -> SizeDistParams:
    """Compute the pow-heavy PSD parameters once per cell
    (reference ``src/Microphysics1M.jl:375-388``), entirely in shared log
    space: one log per input field (rho, q_rai, q_sno, q_icl) and one exp
    per lambda."""
    rho = thermo.rho
    dt = float_dtype(rho)
    eps = eps_numerics(dt)
    tiny = _tiny(dt)
    log_eps = math.log(eps)

    def logc(x):
        return torch.log(torch.clamp(clamp_to_nonneg(x), min=tiny))

    log_rho = logc(rho)
    log_q_rai = logc(micro.q_rai)
    log_q_sno = logc(micro.q_sno)
    log_q_icl = logc(micro.q_icl)

    rain, snow, ice = mp.precip.rain, mp.precip.snow, mp.cloud.ice

    # intercepts: rain/ice fixed; snow n0 = mu (rho q)^nu gated on presence
    # (log(max(q, eps)) == max(log q, log eps) by monotonicity)
    log_n0_rai = math.log(max(rain.pdf.n0, eps))
    log_n0_icl = math.log(max(ice.pdf.n0, eps))
    log_n0_sno_raw = math.log(snow.pdf.mu) + snow.pdf.nu * (
        log_rho + torch.clamp(log_q_sno, min=log_eps))
    present = micro.q_sno > eps
    n0_sno = torch.where(present, torch.exp(log_n0_sno_raw),
                         torch.zeros_like(rho))
    log_n0_sno = torch.where(present,
                             torch.clamp(log_n0_sno_raw, min=log_eps),
                             torch.full_like(rho, log_eps))

    log_lam_rai = _log_lambda_inverse(
        rain.mass, micro.q_rai, log_q_rai, log_rho, log_n0_rai)
    log_lam_sno = _log_lambda_inverse(
        snow.mass, micro.q_sno, log_q_sno, log_rho, log_n0_sno)
    log_lam_icl = _log_lambda_inverse(
        ice.mass, micro.q_icl, log_q_icl, log_rho, log_n0_icl)

    return SizeDistParams(
        lambda_inv_rai=torch.exp(log_lam_rai),
        n0_rai=get_n0(rain.pdf, micro.q_rai, rho),
        v0_rai=get_v0(mp.terminal_velocity.rain, rho),
        lambda_inv_sno=torch.exp(log_lam_sno),
        n0_sno=n0_sno,
        v0_sno=get_v0(mp.terminal_velocity.snow, rho),
        lambda_inv_icl=torch.exp(log_lam_icl),
        n0_icl=get_n0(ice.pdf),
        log_lambda_inv_rai=log_lam_rai,
        log_lambda_inv_sno=log_lam_sno,
        log_lambda_inv_icl=log_lam_icl,
    )


def _pow_lambda_over_r0(lambda_inv, r0, p, log_lambda_inv=None):
    """``(lambda_inv / r0) ** p`` — one fused exp when the log is known."""
    if log_lambda_inv is not None:
        return torch.exp(p * (log_lambda_inv - math.log(r0)))
    return (lambda_inv / r0) ** p


# ---------------------------------------------------------------------------
# Aspect ratio (reference src/Microphysics1M.jl:169-193)
# ---------------------------------------------------------------------------

def aspect_ratio_coeffs(snow_shape: str, mass: P1.ParticleMass,
                        area: P1.ParticleArea, rho_i):
    """Power-law aspect ratio phi(D) = phi0 D^alpha + Chen2022 kappa."""
    if snow_shape == OBLATE:
        alpha = mass.me + mass.dm - 1.5 * (area.ae + area.da)
        phi0 = (
            3 * math.sqrt(PI) / 4 / rho_i * mass.chim * mass.m0
            / (area.chia * area.a0) ** 1.5 / (2 * mass.r0) ** alpha
        )
        kappa = 1.0 / 3.0
    elif snow_shape == PROLATE:
        alpha = 3 * (area.ae + area.da) - 2 * (mass.me + mass.dm)
        phi0 = (
            16 * rho_i**2 / 9 / PI * (area.chia * area.a0) ** 3
            / (mass.chim * mass.m0) ** 2 / (2 * mass.r0) ** alpha
        )
        kappa = -1.0 / 6.0
    else:
        raise ValueError(f"unknown snow shape {snow_shape!r}")
    return phi0, alpha, kappa


# ---------------------------------------------------------------------------
# Terminal velocities (reference src/Microphysics1M.jl:223-324)
# ---------------------------------------------------------------------------

def terminal_velocity(precip, vel, rho, q, snow_shape: Optional[str] = None,
                      v0=None, lambda_inv=None, log_lambda_inv=None):
    """Mass-weighted bulk terminal velocity [m/s].

    Dispatches on the velocity parameterization type: power-law
    (``Blk1MVelType*``), Chen2022 rain (Table B1), or Chen2022 large-ice
    for snow (Table B4, with optional Oblate/Prolate aspect-ratio
    correction). Pass ``log_lambda_inv`` (from :class:`SizeDistParams`) to
    fold the fractional power into one exp.
    """
    eps = eps_numerics(float_dtype(rho, q))

    if isinstance(vel, (Blk1MVelTypeRain, Blk1MVelTypeSnow)):
        if v0 is None:
            v0 = get_v0(vel, rho)
        if lambda_inv is None:
            lambda_inv = lambda_inverse(precip.pdf, precip.mass, q, rho)
        mass = precip.mass
        fall_w = (
            vel.chiv * v0
            * _pow_lambda_over_r0(lambda_inv, mass.r0, vel.ve + vel.dv,
                                  log_lambda_inv)
            * vel.gamma_term / mass.gamma_coeff
        )
        return torch.where(q > eps, fall_w, torch.zeros_like(fall_w))

    if isinstance(vel, Chen2022VelTypeRain):
        aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(vel, rho)
        lam_inv_r = (lambda_inverse(precip.pdf, precip.mass, q, rho)
                     if lambda_inv is None else lambda_inv)
        lam_inv_d = 2 * lam_inv_r
        fall_w = sum(
            CO.chen2022_exponential_pdf(a, b, c, lam_inv_d, 3)
            for a, b, c in zip(aiu, bi, ciu)
        )
        fall_w = clamp_to_nonneg(fall_w)
        return torch.where(q > eps, fall_w, torch.zeros_like(fall_w))

    if isinstance(vel, Chen2022VelTypeLargeIce):
        aiu, bi, ciu = CO.chen2022_vel_coeffs_large_ice(vel, rho, precip.rho_i)
        lam_inv_r = (lambda_inverse(precip.pdf, precip.mass, q, rho)
                     if lambda_inv is None else lambda_inv)
        lam_inv_d = 2 * lam_inv_r
        if snow_shape is None:
            phi_k = precip.aspr.phi ** precip.aspr.kappa
        else:
            phi0, alpha, kappa = aspect_ratio_coeffs(
                snow_shape, precip.mass, precip.area, precip.rho_i
            )
            gamma_aspect = (
                precip.gamma_aspect_oblate
                if snow_shape == OBLATE
                else precip.gamma_aspect_prolate
            )
            if log_lambda_inv is not None:
                phi_av = phi0 * torch.exp(alpha * log_lambda_inv) * gamma_aspect
            else:
                phi_av = phi0 * lam_inv_r**alpha * gamma_aspect
            phi_k = phi_av**kappa
        fall_w = phi_k * sum(
            CO.chen2022_exponential_pdf(a, b, c, lam_inv_d, 3)
            for a, b, c in zip(aiu, bi, ciu)
        )
        fall_w = clamp_to_nonneg(fall_w)
        return torch.where(q > eps, fall_w, torch.zeros_like(fall_w))

    raise TypeError(f"unsupported velocity parameterization {type(vel)}")


# ---------------------------------------------------------------------------
# Autoconversion (reference src/Microphysics1M.jl:339-446)
# ---------------------------------------------------------------------------

def conv_q_lcl_to_q_rai(mp: P1.Microphysics1MParams, tps: TPS,
                        micro: MicroState, thermo: ThermoState):
    """Rain autoconversion tendency [kg/kg/s] (Kessler / PrescribedNd)."""
    opt = mp.processes.rain_autoconversion
    if opt is None:
        return torch.zeros_like(micro.q_lcl)
    pp = mp.process_params.rain_autoconversion
    if opt == P1.KESSLER_1M:
        return CO.logistic_function_integral(
            micro.q_lcl, pp.q_threshold, pp.k
        ) / pp.tau
    if opt == P1.PRESCRIBED_ND:
        # Azimi et al. 2023 variable timescale
        return clamp_to_nonneg(micro.q_lcl) / (
            pp.tau * (pp.Nc / 1e8) ** pp.alpha
        )
    raise ValueError(f"unknown rain autoconversion option {opt!r}")


def conv_q_icl_to_q_sno(mp: P1.Microphysics1MParams, tps: TPS,
                        micro: MicroState, thermo: ThermoState,
                        sd: Optional[SizeDistParams] = None):
    """Snow autoconversion tendency [kg/kg/s]
    (reference ``src/Microphysics1M.jl:412-446``)."""
    opt = mp.processes.snow_autoconversion
    if opt is None:
        return torch.zeros_like(micro.q_icl)
    pp = mp.process_params.snow_autoconversion
    if opt == P1.NO_SUPERSATURATION:
        return CO.logistic_function_integral(
            micro.q_icl, pp.q_threshold, pp.k
        ) / pp.tau
    if opt == P1.WITH_SUPERSATURATION:
        if sd is None:
            sd = size_distr_parameters(mp, micro, thermo)
        eps = eps_numerics(float_dtype(thermo.rho))
        rho, T = thermo.rho, thermo.T
        r_is = pp.r_ice_snow
        mass = mp.cloud.ice.mass
        S = TDI.supersaturation_over_ice(
            tps, micro.q_tot, micro.q_lcl + micro.q_rai,
            micro.q_icl + micro.q_sno, rho, T,
        )
        G = CO.G_func_ice(mp.air_properties, tps, T)
        lam_inv = sd.lambda_inv_icl
        n0 = sd.n0_icl
        acnv_rate = (
            4 * PI * S * G * n0 / rho
            * torch.exp(-r_is / lam_inv)
            * (r_is**2 / (mass.me + mass.dm)
               + (r_is / lam_inv + 1) * lam_inv**2)
        )
        cond = (micro.q_icl > eps) & (S > 0) & (T < tps.T_freeze)
        return torch.where(cond, acnv_rate, torch.zeros_like(acnv_rate))
    raise ValueError(f"unknown snow autoconversion option {opt!r}")


# ---------------------------------------------------------------------------
# Accretion (reference src/Microphysics1M.jl:467-680, wrappers :707-897)
# ---------------------------------------------------------------------------

def warm_accretion_melt_factor(tps: TPS, T):
    """Sensible-to-latent heat ratio for warm collected liquid on snow
    (reference ``src/Microphysics1M.jl:448-466``)."""
    L_f = TDI.latent_heat_fusion(tps, T)
    dT = T - tps.T_freeze
    factor = tps.cv_l / L_f * dT
    return torch.where(T <= tps.T_freeze, torch.zeros_like(factor), factor)


def _accretion_kernel(precip, vel, E, q_clo, q_pre, rho, n0, v0, lambda_inv,
                      log_lambda_inv=None):
    """Low-level cloud-water x precipitation collision kernel
    (reference ``src/Microphysics1M.jl:491-518``)."""
    eps = eps_numerics(float_dtype(q_clo, rho))
    area = precip.area
    r0 = precip.mass.r0
    p = area.ae + vel.ve + area.da + vel.dv
    accr_rate = (
        q_clo * E * n0 * area.a0 * v0 * area.chia * vel.chiv * lambda_inv
        * vel.gamma_accr
        * _pow_lambda_over_r0(lambda_inv, r0, p, log_lambda_inv)
    )
    cond = (q_clo > eps) & (q_pre > eps)
    return torch.where(cond, accr_rate, torch.zeros_like(accr_rate))


def _accretion_rain_sink_kernel(rain, ice, vel, E, q_icl, q_rai, rho,
                                n0_ice, lambda_ice_inv, n0, v0, lambda_inv,
                                log_lambda_inv=None):
    """Rain sink from collisions with cloud ice
    (reference ``src/Microphysics1M.jl:535-578``)."""
    eps = eps_numerics(float_dtype(q_icl, rho))
    mass, area = rain.mass, rain.area
    p = mass.me + area.ae + vel.ve + mass.dm + area.da + vel.dv
    accr_rate = (
        E / rho * n0 * n0_ice * mass.m0 * area.a0 * v0
        * mass.chim * area.chia * vel.chiv * lambda_ice_inv * lambda_inv
        * vel.gamma_accr_rain_sink
        * _pow_lambda_over_r0(lambda_inv, mass.r0, p, log_lambda_inv)
    )
    cond = (q_icl > eps) & (q_rai > eps)
    return torch.where(cond, accr_rate, torch.zeros_like(accr_rate))


def _accretion_snow_rain_kernel(type_i, type_j, vel_i, vel_j, E_ij, coeff_disp,
                                q_i, q_j, rho, n0_i, n0_j, v0_i, v0_j,
                                lambda_i_inv, lambda_j_inv,
                                log_lambda_i_inv=None, log_lambda_j_inv=None):
    """Two-sided rain-snow collision kernel with velocity dispersion
    (reference ``src/Microphysics1M.jl:604-680``)."""
    eps = eps_numerics(float_dtype(q_i, rho))
    mass_j = type_j.mass
    delta = mass_j.me + mass_j.dm

    v_ti = terminal_velocity(type_i, vel_i, rho, q_i,
                             v0=v0_i, lambda_inv=lambda_i_inv,
                             log_lambda_inv=log_lambda_i_inv)
    v_tj = terminal_velocity(type_j, vel_j, rho, q_j,
                             v0=v0_j, lambda_inv=lambda_j_inv,
                             log_lambda_inv=log_lambda_j_inv)
    dv_eff = torch.sqrt(
        (v_ti - v_tj) ** 2 + coeff_disp * (v_ti**2 + v_tj**2)
    )
    accr_rate = (
        PI / rho * n0_i * n0_j * mass_j.m0 * mass_j.chim * E_ij * dv_eff
        * mass_j.gamma_coeff / mass_j.r0**delta
        * (
            2 * lambda_i_inv**3 * lambda_j_inv ** (delta + 1)
            + 2 * (delta + 1) * lambda_i_inv**2 * lambda_j_inv ** (delta + 2)
            + (delta + 2) * (delta + 1) * lambda_i_inv
            * lambda_j_inv ** (delta + 3)
        )
    )
    cond = (q_i > eps) & (q_j > eps)
    return torch.where(cond, accr_rate, torch.zeros_like(accr_rate))


def accretion_cloud_liquid_rain(mp, tps, micro, thermo, sd=None):
    """q_lcl + q_rai -> q_rai (reference src/Microphysics1M.jl:709-732)."""
    if mp.processes.cloud_liquid_rain_accretion is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    return _accretion_kernel(
        mp.precip.rain, mp.terminal_velocity.rain,
        mp.process_params.cloud_liquid_rain_accretion.e,
        micro.q_lcl, micro.q_rai, thermo.rho,
        sd.n0_rai, sd.v0_rai, sd.lambda_inv_rai, sd.log_lambda_inv_rai,
    )


def accretion_cloud_liquid_snow(mp, tps, micro, thermo, sd=None):
    """q_lcl + q_sno -> q_sno (cold) with warm thermal-melt arm; returns
    ``(S_accr, S_melt)`` (reference src/Microphysics1M.jl:734-760)."""
    if mp.processes.cloud_liquid_snow_accretion is None:
        z = torch.zeros_like(thermo.T)
        return z, z
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    S = _accretion_kernel(
        mp.precip.snow, mp.terminal_velocity.snow,
        mp.process_params.cloud_liquid_snow_accretion.e,
        micro.q_lcl, micro.q_sno, thermo.rho,
        sd.n0_sno, sd.v0_sno, sd.lambda_inv_sno, sd.log_lambda_inv_sno,
    )
    alpha = warm_accretion_melt_factor(tps, thermo.T)
    return S, alpha * S


def accretion_cloud_ice_rain(mp, tps, micro, thermo, sd=None):
    """q_icl + q_rai -> q_sno (reference src/Microphysics1M.jl:762-785)."""
    if mp.processes.cloud_ice_rain_accretion is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    return _accretion_kernel(
        mp.precip.rain, mp.terminal_velocity.rain,
        mp.process_params.cloud_ice_rain_accretion.e,
        micro.q_icl, micro.q_rai, thermo.rho,
        sd.n0_rai, sd.v0_rai, sd.lambda_inv_rai, sd.log_lambda_inv_rai,
    )


def accretion_cloud_ice_snow(mp, tps, micro, thermo, sd=None):
    """q_icl + q_sno -> q_sno (reference src/Microphysics1M.jl:787-812)."""
    if mp.processes.cloud_ice_snow_accretion is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    return _accretion_kernel(
        mp.precip.snow, mp.terminal_velocity.snow,
        mp.process_params.cloud_ice_snow_accretion.e,
        micro.q_icl, micro.q_sno, thermo.rho,
        sd.n0_sno, sd.v0_sno, sd.lambda_inv_sno, sd.log_lambda_inv_sno,
    )


def accretion_rain_sink(mp, tps, micro, thermo, sd=None):
    """Rain sink arm of cloud-ice/rain accretion
    (reference src/Microphysics1M.jl:869-897)."""
    if mp.processes.cloud_ice_rain_accretion is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    return _accretion_rain_sink_kernel(
        mp.precip.rain, mp.cloud.ice, mp.terminal_velocity.rain,
        mp.process_params.cloud_ice_rain_accretion.e,
        micro.q_icl, micro.q_rai, thermo.rho,
        sd.n0_icl, sd.lambda_inv_icl,
        sd.n0_rai, sd.v0_rai, sd.lambda_inv_rai, sd.log_lambda_inv_rai,
    )


def accretion_snow_rain(mp, tps, micro, thermo, sd=None):
    """Two-sided rain-snow collisions; returns
    ``(S_rai_sno, S_sno_rai, S_melt)``
    (reference src/Microphysics1M.jl:815-867)."""
    if mp.processes.rain_snow_accretion is None:
        z = torch.zeros_like(thermo.T)
        return z, z, z
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    pp = mp.process_params.rain_snow_accretion
    vel = mp.terminal_velocity
    sno, rai = mp.precip.snow, mp.precip.rain
    rho = thermo.rho
    S_rai_sno = _accretion_snow_rain_kernel(
        sno, rai, vel.snow, vel.rain, pp.e, pp.coeff_disp,
        micro.q_sno, micro.q_rai, rho,
        sd.n0_sno, sd.n0_rai, sd.v0_sno, sd.v0_rai,
        sd.lambda_inv_sno, sd.lambda_inv_rai,
        sd.log_lambda_inv_sno, sd.log_lambda_inv_rai,
    )
    S_sno_rai = _accretion_snow_rain_kernel(
        rai, sno, vel.rain, vel.snow, pp.e, pp.coeff_disp,
        micro.q_rai, micro.q_sno, rho,
        sd.n0_rai, sd.n0_sno, sd.v0_rai, sd.v0_sno,
        sd.lambda_inv_rai, sd.lambda_inv_sno,
        sd.log_lambda_inv_rai, sd.log_lambda_inv_sno,
    )
    alpha = warm_accretion_melt_factor(tps, thermo.T)
    return S_rai_sno, S_sno_rai, alpha * S_rai_sno


# ---------------------------------------------------------------------------
# Evaporation / sublimation / melt (reference src/Microphysics1M.jl:899-1139)
# ---------------------------------------------------------------------------

def _ventilated_lambda_term(mass_r0, vel, vent, aps, v0, lambda_inv,
                            log_lambda_inv=None):
    """Common ventilation bracket: a + b Sc^(1/3) sqrt(2 v0 chi_v lam/nu) /
    (r0 lam)^((ve+dv)/2) * gamma_vent."""
    eps = eps_numerics(float_dtype(lambda_inv))
    Sc = aps.nu_air / max(aps.D_vapor, eps)
    return (
        vent.a
        + vent.b * Sc ** (1.0 / 3.0)
        * _pow_lambda_over_r0(lambda_inv, mass_r0, (vel.ve + vel.dv) / 2,
                              log_lambda_inv)
        * torch.sqrt(2 * v0 * vel.chiv / aps.nu_air * lambda_inv)
        * vel.gamma_vent
    )


def conv_q_rai_to_q_vap(mp, tps, micro, thermo, sd=None):
    """Rain evaporation tendency (<= 0) [kg/kg/s]
    (reference src/Microphysics1M.jl:917-960)."""
    if mp.processes.rain_condensation_evaporation is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    eps = eps_numerics(float_dtype(thermo.rho))
    rho, T = thermo.rho, thermo.T
    S = TDI.supersaturation_over_liquid(
        tps, micro.q_tot, micro.q_lcl + micro.q_rai,
        micro.q_icl + micro.q_sno, rho, T,
    )
    G = CO.G_func_liquid(mp.air_properties, tps, T)
    vent_term = _ventilated_lambda_term(
        mp.precip.rain.mass.r0, mp.terminal_velocity.rain,
        mp.precip.rain.vent, mp.air_properties, sd.v0_rai, sd.lambda_inv_rai,
        sd.log_lambda_inv_rai,
    )
    evap_rate = (
        4 * PI * sd.n0_rai / rho * S * G * sd.lambda_inv_rai**2 * vent_term
    )
    cond = (micro.q_rai > eps) & (S < 0)
    rate = torch.where(cond, evap_rate, torch.zeros_like(evap_rate))
    return torch.clamp(rate, max=0.0)


def _snow_subl_dep_rate(mp, tps, micro, thermo, sd):
    """Snow sublimation/deposition physics kernel
    (reference src/Microphysics1M.jl:1000-1037)."""
    eps = eps_numerics(float_dtype(thermo.rho))
    rho, T = thermo.rho, thermo.T
    S = TDI.supersaturation_over_ice(
        tps, micro.q_tot, micro.q_lcl + micro.q_rai,
        micro.q_icl + micro.q_sno, rho, T,
    )
    G = CO.G_func_ice(mp.air_properties, tps, T)
    vent_term = _ventilated_lambda_term(
        mp.precip.snow.mass.r0, mp.terminal_velocity.snow,
        mp.precip.snow.vent, mp.air_properties, sd.v0_sno, sd.lambda_inv_sno,
        sd.log_lambda_inv_sno,
    )
    subl_rate = (
        4 * PI * sd.n0_sno / rho * S * G * sd.lambda_inv_sno**2 * vent_term
    )
    return torch.where(micro.q_sno > eps, subl_rate,
                       torch.zeros_like(subl_rate))


def conv_q_sno_to_q_vap(mp, tps, micro, thermo, sd=None):
    """Snow sublimation (or sublimation + deposition) tendency [kg/kg/s]
    (reference src/Microphysics1M.jl:977-998)."""
    opt = mp.processes.snow_deposition_sublimation
    if opt is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    rate = _snow_subl_dep_rate(mp, tps, micro, thermo, sd)
    if opt == P1.SUBLIMATION_ONLY:
        return torch.clamp(rate, max=0.0)
    if opt == P1.DEPOSITION_AND_SUBLIMATION:
        return rate
    raise ValueError(f"unknown snow dep/subl option {opt!r}")


def conv_q_icl_to_q_lcl(mp, tps, micro, thermo, sd=None):
    """Cloud ice melt tendency [kg/kg/s]
    (reference src/Microphysics1M.jl:1055-1077)."""
    if mp.processes.cloud_ice_melt is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    eps = eps_numerics(float_dtype(thermo.rho))
    rho, T = thermo.rho, thermo.T
    L = TDI.latent_heat_fusion(tps, T)
    n0 = mp.cloud.ice.pdf.n0
    lam_inv = sd.lambda_inv_icl
    rate = (
        4 * PI * n0 / rho * mp.air_properties.K_therm / L
        * (T - tps.T_freeze) * lam_inv**2
    )
    cond = (micro.q_icl > eps) & (T > tps.T_freeze)
    return torch.where(cond, rate, torch.zeros_like(rate))


def conv_q_sno_to_q_rai(mp, tps, micro, thermo, sd=None):
    """Snow melt tendency [kg/kg/s]
    (reference src/Microphysics1M.jl:1094-1139)."""
    if mp.processes.snow_melt is None:
        return torch.zeros_like(thermo.T)
    if sd is None:
        sd = size_distr_parameters(mp, micro, thermo)
    eps = eps_numerics(float_dtype(thermo.rho))
    rho, T = thermo.rho, thermo.T
    L = TDI.latent_heat_fusion(tps, T)
    vent_term = _ventilated_lambda_term(
        mp.precip.snow.mass.r0, mp.terminal_velocity.snow,
        mp.precip.snow.vent, mp.air_properties, sd.v0_sno, sd.lambda_inv_sno,
        sd.log_lambda_inv_sno,
    )
    rate = (
        4 * PI * sd.n0_sno / rho * mp.air_properties.K_therm / L
        * (T - tps.T_freeze) * sd.lambda_inv_sno**2 * vent_term
    )
    cond = (micro.q_sno > eps) & (T > tps.T_freeze)
    return torch.where(cond, rate, torch.zeros_like(rate))
