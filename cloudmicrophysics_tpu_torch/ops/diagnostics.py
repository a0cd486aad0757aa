"""Cloud diagnostics: radar reflectivity and effective radius.

Port of ``cloudmicrophysics_tpu/ops/diagnostics.py`` (reference
``src/CloudDiagnostics.jl``). Every moment taken of a PSD parameter that
can be zero or non-finite is taken of a guarded copy and then masked, as
in the JAX package, so that no discarded branch is NaN.
"""

from __future__ import annotations

import math

import torch

from ..parameters import m1 as P1
from ..parameters import m2 as P2
from ..utils import distributions as DT
from ..utils.special import eps_numerics, float_dtype, floatmin
from . import m1 as CM1
from . import m2 as CM2

PI = math.pi

__all__ = [
    "radar_reflectivity_1m",
    "radar_reflectivity_2m",
    "effective_radius_2m",
    "effective_radius_liu_hallet_97",
    "effective_radius_const",
]


def radar_reflectivity_1m(rain: P1.Rain, q, rho):
    """Logarithmic radar reflectivity [dBZ] for the 1M rain PSD, clipped at
    -150 dBZ (reference src/CloudDiagnostics.jl:30-45)."""
    n0 = CM1.get_n0(rain.pdf) * 1e-12
    lam_inv = CM1.lambda_inverse(rain.pdf, rain.mass, q, rho) / 1e-3
    Z = 720 * n0 * lam_inv**7
    log_10_Z0 = -18.0
    log_Z = 10 * (torch.log10(Z) - log_10_Z0 - 9)
    return torch.clamp(log_Z, min=-150.0)


def _notvalid(B):
    return (B == 0) | ~torch.isfinite(B)


def _guarded(B):
    """``(B or 1 where B is zero or non-finite, that mask)``."""
    bad = _notvalid(B)
    return torch.where(bad, torch.ones_like(B), B), bad


def radar_reflectivity_2m(sb: P2.SB2006, q_lcl, q_rai, N_lcl, N_rai, rho_air):
    """Logarithmic radar reflectivity [dBZ] for SB2006 cloud + rain PSDs
    (reference src/CloudDiagnostics.jl:63-83)."""
    dt = float_dtype(q_lcl, rho_air)
    pdf_c, pdf_r = sb.pdf_c, sb.pdf_r
    C = 4 / 3 * PI * pdf_r.rho_w
    log_10_Z0 = -18.0

    _, Br = CM2.pdf_rain_parameters_mass(pdf_r, q_rai, rho_air, N_rai)
    _, Bc = CM2.pdf_cloud_parameters_mass(pdf_c, q_lcl, rho_air, N_lcl)

    n_mass = 2
    Bc_safe, bad_c = _guarded(Bc)
    Br_safe, bad_r = _guarded(Br)
    Zc = torch.where(
        bad_c, torch.zeros_like(Bc),
        DT.generalized_gamma_moment(pdf_c.nu_c, pdf_c.mu_c, Bc_safe, N_lcl,
                                    n_mass) / C**n_mass)
    Zr = torch.where(
        bad_r, torch.zeros_like(Br),
        DT.generalized_gamma_moment(pdf_r.nu_r, pdf_r.mu_r, Br_safe, N_rai,
                                    n_mass) / C**n_mass)
    Z = torch.clamp(Zc + Zr, min=floatmin(dt))
    return torch.clamp(10 * (torch.log10(Z) - log_10_Z0), min=-150.0)


def effective_radius_2m(sb: P2.SB2006, q_lcl, q_rai, N_lcl, N_rai, rho_air):
    """Effective radius from SB2006 gamma moments
    (reference src/CloudDiagnostics.jl:99-123)."""
    dt = float_dtype(q_lcl, rho_air)
    pdf_c, pdf_r = sb.pdf_c, sb.pdf_r
    C = 4 / 3 * PI * pdf_r.rho_w
    _, Br = CM2.pdf_rain_parameters_mass(pdf_r, q_rai, rho_air, N_rai)
    _, Bc = CM2.pdf_cloud_parameters_mass(pdf_c, q_lcl, rho_air, N_lcl)
    Bc_safe, bad_c = _guarded(Bc)
    Br_safe, bad_r = _guarded(Br)

    def moment(nu, mu, B, N, n):
        return DT.generalized_gamma_moment(nu, mu, B, N, n) / C**n

    M3_c = torch.where(bad_c, torch.zeros_like(Bc),
                       moment(pdf_c.nu_c, pdf_c.mu_c, Bc_safe, N_lcl, 1))
    M3_r = torch.where(bad_r, torch.zeros_like(Br),
                       moment(pdf_r.nu_r, pdf_r.mu_r, Br_safe, N_rai, 1))
    n23 = 2.0 / 3.0
    M2_c = torch.where(bad_c, torch.zeros_like(Bc),
                       moment(pdf_c.nu_c, pdf_c.mu_c, Bc_safe, N_lcl, n23))
    M2_r = torch.where(bad_r, torch.zeros_like(Br),
                       moment(pdf_r.nu_r, pdf_r.mu_r, Br_safe, N_rai, n23))
    denom = M2_c + M2_r
    denom_safe = torch.clamp(denom, min=floatmin(dt))
    out = (M3_c + M3_r) / denom_safe
    return torch.where(denom <= eps_numerics(dt), torch.zeros_like(out), out)


def effective_radius_liu_hallet_97(rho_w: float, rho_air, q_lcl,
                                   N_lcl=100.0, q_rai=0.0, N_rai=0.0):
    """"1/3" power-law effective radius (Liu & Hallett 1997;
    reference src/CloudDiagnostics.jl:139-171)."""
    dt = float_dtype(rho_air, q_lcl)
    eps = eps_numerics(dt)
    k = 0.8
    N_tot = N_lcl + N_rai
    # N_lcl and N_rai may both be Python numbers (the defaults)
    tensor_N = isinstance(N_tot, torch.Tensor)
    N_safe = torch.clamp(N_tot, min=eps) if tensor_N else max(N_tot, eps)
    arg = (3 * (q_lcl + q_rai) * rho_air) / (4 * PI * rho_w * N_safe)
    r_vol = torch.clamp(arg, min=floatmin(dt)) ** (1 / 3)
    if tensor_N:
        r_vol = torch.where(N_tot < eps, torch.zeros_like(r_vol), r_vol)
    elif N_tot < eps:
        r_vol = torch.zeros_like(r_vol)
    return r_vol / k ** (1 / 3)


def effective_radius_const(cloud_params):
    """Constant assumed effective radius
    (reference src/CloudDiagnostics.jl:180-185)."""
    return cloud_params.r_eff
