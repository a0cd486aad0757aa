"""Shared physics helpers (L3).

Port of ``cloudmicrophysics_tpu/ops/common.py`` (reference
``src/Common.jl``): thermal conductivity/diffusivity G-functions, smooth
logistic threshold functions, water activities, Chen 2022
terminal-velocity coefficients and bulk velocity sums, and ventilation
factors. All elementwise and branchless.

Parameter-only sub-expressions (functions of ``rho_i`` and the Chen 2022
tables) are evaluated on the host when their inputs are Python floats,
so they reach the tensor arithmetic as Python floats.
"""

from __future__ import annotations

import math

import torch

from ..parameters.common import AirProperties
from ..parameters.terminal_velocity import (
    Chen2022VelTypeLargeIce,
    Chen2022VelTypeRain,
    Chen2022VelTypeSmallIce,
)
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import eps_numerics, expm1, fac, float_dtype, lgamma
from . import thermo as TDI

__all__ = [
    "G_func_liquid",
    "G_func_ice",
    "logistic_function",
    "logistic_function_integral",
    "H2SO4_soln_saturation_vapor_pressure",
    "a_w_xT",
    "a_w_eT",
    "a_w_ice",
    "chen2022_vel_coeffs_rain",
    "chen2022_vel_coeffs_small_ice",
    "chen2022_vel_coeffs_large_ice",
    "chen2022_exponential_pdf",
    "chen2022_velocity_sum",
    "volume_sphere_D",
    "volume_sphere_R",
]

TPS = ThermodynamicsParameters


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _log1pexp(x):
    """Stable ``log(1 + exp(x))``."""
    return torch.logaddexp(torch.zeros_like(x), x)


def _log1mexp(x):
    """Stable ``log(1 - exp(x))`` for x < 0."""
    x_hi = torch.clamp(x, max=-torch.finfo(x.dtype).tiny)
    return torch.where(
        x > -math.log(2.0), torch.log(-expm1(x_hi)),
        torch.log1p(-torch.exp(x_hi)))


def G_func_liquid(aps: AirProperties, tps: TPS, T):
    """Combined conductivity/diffusivity factor for vapor <-> liquid
    (reference src/Common.jl:47-63)."""
    eps = eps_numerics(float_dtype(T))
    R_v = tps.R_v
    L = TDI.latent_heat_vapor(tps, T)
    p_vs = torch.clamp(TDI.saturation_vapor_pressure_over_liquid(tps, T),
                       min=eps)
    D_vapor = max(aps.D_vapor, eps)
    K_therm = max(aps.K_therm, eps)
    return 1 / (L / K_therm / T * (L / R_v / T - 1) + R_v * T / D_vapor / p_vs)


def G_func_ice(aps: AirProperties, tps: TPS, T):
    """Combined conductivity/diffusivity factor for vapor <-> ice
    (reference src/Common.jl:86-102)."""
    eps = eps_numerics(float_dtype(T))
    R_v = tps.R_v
    L = TDI.latent_heat_sublim(tps, T)
    p_vs = torch.clamp(TDI.saturation_vapor_pressure_over_ice(tps, T),
                       min=eps)
    D_vapor = max(aps.D_vapor, eps)
    K_therm = max(aps.K_therm, eps)
    return 1 / (L / K_therm / T * (L / R_v / T - 1) + R_v * T / D_vapor / p_vs)


def logistic_function(x, x_0, k):
    """Smooth 0 -> 1 transition at threshold ``x_0``
    (reference src/Common.jl:125-139)."""
    dt = float_dtype(x, x_0, k)
    eps = eps_numerics(dt)
    x = torch.clamp(torch.as_tensor(x, dtype=dt), min=0.0)
    x0 = torch.as_tensor(x_0, dtype=dt, device=x.device)
    x_safe = torch.clamp(x, min=eps)
    x0_safe = torch.clamp(x0, min=eps)
    z = k * (x_safe / x0_safe - x0_safe / x_safe)
    result = torch.exp(-_log1pexp(-z))
    zero, one = torch.zeros_like(result), torch.ones_like(result)
    result = torch.where(x < eps, zero, result)
    return torch.where(x0 < eps, torch.where(x < eps, zero, one), result)


def logistic_function_integral(x, x_0, k):
    """Integral of the logistic function: smooth 0 -> (x - x_0) ramp
    (reference src/Common.jl:157-173)."""
    dt = float_dtype(x, x_0, k)
    eps = eps_numerics(dt)
    x = torch.clamp(torch.as_tensor(x, dtype=dt), min=0.0)
    x0 = torch.as_tensor(x_0, dtype=dt, device=x.device)
    x_safe = torch.clamp(x, min=eps)
    x0_safe = torch.clamp(x0, min=eps)
    k = torch.as_tensor(k, dtype=dt, device=x.device)
    trnslt = -_log1mexp(-k) / k
    kt = k * (x_safe / x0_safe - 1 + trnslt)
    result = (_log1pexp(kt) / k - trnslt) * x0_safe
    result = torch.where(x < eps, torch.zeros_like(result), result)
    return torch.where(x0 < eps, x, result)


def heaviside(x):
    return torch.where(x > 0, torch.ones_like(x), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Water activities (reference src/Common.jl:188-271)
# ---------------------------------------------------------------------------

def H2SO4_soln_saturation_vapor_pressure(prs, x, T):
    """Saturation vapor pressure over a sulphuric acid solution [Pa]
    (reference src/Common.jl:188-212)."""
    w_h = prs.w_2 * x
    return (
        torch.exp(
            prs.c1 - prs.c2 * x + prs.c3 * x * w_h - prs.c4 * x * w_h**2
            + (prs.c5 + prs.c6 * x - prs.c7 * x * w_h) / T
        )
        * 100.0  # mbar -> Pa
    )


def a_w_xT(H2SO4_prs, tps: TPS, x, T):
    """Water activity of an H2SO4-containing droplet."""
    p_sol = H2SO4_soln_saturation_vapor_pressure(H2SO4_prs, x, T)
    return p_sol / TDI.saturation_vapor_pressure_over_liquid(tps, T)


def a_w_eT(tps: TPS, e, T):
    """Water activity (= RH) of a pure water droplet."""
    return e / TDI.saturation_vapor_pressure_over_liquid(tps, T)


def a_w_ice(tps: TPS, T):
    """Water activity of ice."""
    return TDI.saturation_vapor_pressure_over_ice(
        tps, T
    ) / TDI.saturation_vapor_pressure_over_liquid(tps, T)


# ---------------------------------------------------------------------------
# Chen 2022 terminal velocity coefficients (reference src/Common.jl:274-349)
# ---------------------------------------------------------------------------

def chen2022_vel_coeffs_rain(coeffs: Chen2022VelTypeRain, rho_a):
    """Table B1 coefficients evaluated at air density; unit-converted
    (reference src/Common.jl:290-302). The three ``1000^b_i`` unit
    conversions share one ``exp`` of the common rho dependence."""
    rho_a = torch.clamp(rho_a, min=0.0)
    a1, a2, a3 = coeffs.a
    b1, b2, b3 = coeffs.b
    c1, c2, c3 = coeffs.c
    shared = torch.exp(coeffs.rho0 * rho_a
                       - coeffs.b_rho * rho_a * math.log(1000.0))
    log_rho_a = torch.log(rho_a)
    ai_unit = (a1 * 1000.0**b1 * shared,
               a2 * 1000.0**b2 * shared,
               a3 * 1000.0**b3 * shared
               * torch.exp(coeffs.a3_pow * log_rho_a))
    bi = (b1 - coeffs.b_rho * rho_a,
          b2 - coeffs.b_rho * rho_a,
          b3 - coeffs.b_rho * rho_a)
    ciu = (c1 * 1000.0, c2 * 1000.0, c3 * 1000.0)
    return ai_unit, bi, ciu


def chen2022_small_ice_consts(coeffs: Chen2022VelTypeSmallIce, rho_i):
    """The ice-density-only factors ``(As, Bs, Cs, Es, Fs, Gs)`` of Table
    B2/B3; Python floats for a Python-float ``rho_i``."""
    A, B, C, E, F, G = coeffs.A, coeffs.B, coeffs.C, coeffs.E, coeffs.F, coeffs.G
    log_r = _log(rho_i)
    sqrt_r = _sqrt(rho_i)
    As = A[1] * log_r**2 - A[2] * log_r + A[0]
    Bs = 1 / (B[0] + B[1] * log_r + B[2] / sqrt_r)
    Cs = C[0] + C[1] * _exp(C[2] * rho_i) + C[3] * sqrt_r
    Es = E[0] - E[1] * log_r**2 + E[2] * sqrt_r
    Fs = -_exp(F[0] - F[1] * log_r**2 + F[2] * log_r)
    Gs = 1 / (G[0] + G[1] / log_r - G[2] * log_r / rho_i)
    return As, Bs, Cs, Es, Fs, Gs


def chen2022_vel_coeffs_small_ice(coeffs: Chen2022VelTypeSmallIce, rho_a,
                                  rho_i):
    """Table B2/B3 coefficients (reference src/Common.jl:304-325)."""
    rho_a = torch.clamp(rho_a, min=0.0)
    As, Bs, Cs, Es, Fs, Gs = chen2022_small_ice_consts(coeffs, rho_i)
    # rho_a^As shared by both a_i; both b_i are identical so the unit
    # conversion 1000^b shares one exp
    bi_common = Bs + rho_a * Cs
    rho_pow = torch.exp(As * torch.log(rho_a))
    unit = torch.exp(bi_common * math.log(1000.0))
    aiu = (Es * rho_pow * unit, Fs * rho_pow * unit)
    bi = (bi_common, bi_common)
    ciu = (0.0 * Gs, Gs * 1000.0)
    return aiu, bi, ciu


def chen2022_large_ice_consts(coeffs: Chen2022VelTypeLargeIce, rho_i):
    """The ice-density-only factors ``(Al, Bl, Cl, El, Fl, Gl, Hl)`` of
    Table B4/B5; Python floats for a Python-float ``rho_i``."""
    A, B, C = coeffs.A, coeffs.B, coeffs.C
    E, F, G, H = coeffs.E, coeffs.F, coeffs.G, coeffs.H
    log_r = _log(rho_i)
    sqrt_r = _sqrt(rho_i)
    Al = A[0] + A[1] * log_r + A[2] / (rho_i * sqrt_r)
    Bl = _exp(B[0] + B[1] * log_r**2 + B[2] * log_r)
    Cl = _exp(C[0] + C[1] / log_r + C[2] / rho_i)
    El = E[0] + E[1] * log_r * sqrt_r + E[2] * sqrt_r
    # F[2] < 0: F[0] + F[1] log(rho) - (-F[2]) exp(-rho), in log space to
    # keep the huge |F[2]| finite (src/Common.jl:338)
    Fl = F[0] + F[1] * log_r - _exp(math.log(-F[2]) - rho_i)
    Gl = 1 / (G[0] + G[1] * log_r * sqrt_r + G[2] / sqrt_r)
    Hl = H[0] + H[1] * rho_i**2 * sqrt_r + _exp(math.log(-H[2]) - rho_i)
    return Al, Bl, Cl, El, Fl, Gl, Hl


def chen2022_vel_coeffs_large_ice(coeffs: Chen2022VelTypeLargeIce, rho_a,
                                  rho_i):
    """Table B4/B5 coefficients (reference src/Common.jl:327-349)."""
    rho_a = torch.clamp(rho_a, min=0.0)
    Al, Bl, Cl, El, Fl, Gl, Hl = chen2022_large_ice_consts(coeffs, rho_i)
    rho_pow = torch.exp(Al * torch.log(rho_a))
    ai = (Bl * rho_pow, El * rho_pow * torch.exp(Hl * rho_a))
    bi = (Cl, Fl)
    ci = (0.0 * Gl, Gl)
    aiu = tuple(a * 1000.0**b for a, b in zip(ai, bi))
    ciu = tuple(c * 1000.0 for c in ci)
    return aiu, bi, ciu


def chen2022_exponential_pdf(a, b, c, lambda_inv, k: int):
    """Moment-k bulk fall-speed addend over an exponential PSD
    (reference src/Common.jl:414-422)."""
    delta = float(k + 1)
    gamma_delta = float(fac(k))
    return (
        a
        * torch.exp(
            -delta * torch.log(lambda_inv)
            - (b + delta) * torch.log(1 / lambda_inv + c)
            + lgamma(b + delta)
        )
        / gamma_delta
    )


def chen2022_velocity_sum(aiu, bi, ciu, D, log_D=None):
    """Pointwise terminal velocity: sum_k a_k D^b_k exp(-c_k D)
    (reference src/Common.jl:361-381), as exp(b log D - c D)."""
    if log_D is None:
        log_D = torch.log(D)
    total = None
    for a, b, c in zip(aiu, bi, ciu):
        term = a * torch.exp(b * log_D - c * D)
        total = term if total is None else total + term
    return total


def ventilation_factor(vent, aps: AirProperties, v_term, D):
    """Ventilation factor F_v(D) (SB2006 Eq 24; reference src/Common.jl:506-514).

    Accepts either the 1M ``Ventilation(a, b)`` or a P3-style
    ``VentilationFactor(av, bv)`` coefficient struct.
    """
    a = getattr(vent, "a", None)
    if a is None:
        a, b = vent.av, vent.bv
    else:
        b = vent.b
    N_sc = aps.nu_air / aps.D_vapor
    cbrt_N_sc = N_sc ** (1.0 / 3.0)
    N_Re = D * v_term / aps.nu_air
    return a + b * cbrt_N_sc * torch.sqrt(N_Re)


def volume_sphere_D(D):
    """Sphere volume from diameter: pi/6 D^3."""
    return D**3 * math.pi / 6


def volume_sphere_R(R):
    """Sphere volume from radius."""
    return volume_sphere_D(2 * R)
