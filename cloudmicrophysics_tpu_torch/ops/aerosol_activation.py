"""ARG2000 aerosol activation.

Port of ``cloudmicrophysics_tpu/ops/aerosol_activation.py`` (reference
``src/AerosolActivation.jl``): per-mode mean hygroscopicity, critical
supersaturation, maximum supersaturation (ARG eq 11/12 with Korolev-Mazin
alpha/gamma and liquid/ice condensation-sink corrections), and activated
number/mass via erf/erfc.

The modes are a Python tuple, summed over in their order as the JAX
package sums them. A mode's numeric fields may be Python floats,
tensors of one value per ensemble member, or per-point tensors of the
state's shape (a host model's ``(ncol, nlev)`` grid, each mode's ``N``,
``r_dry`` and species fractions at every point), which broadcast against
the thermodynamic state.

On a CUDA device, :func:`N_activated_per_mode` and
:func:`M_activated_per_mode` are each one launch of a hand-written kernel
(:mod:`..kernels.activation`, ``csrc/activation.cu``) that reads each
point's inputs once and writes its answers once, bit-identical to the
eager code below, which stays their plain version and which CPU tensors
take. The path follows only from the inputs: a call with any tensor on a
CUDA device among the air and the modes' fields launches the kernel, or
raises for what the kernel cannot take (a field on another device, a
gradient to track), never falling back to the eager code.

Spans (:mod:`..trace`, recorded while a profiler records):
``activation.number`` around :func:`N_activated_per_mode`,
``activation.mass`` around :func:`M_activated_per_mode` and
``activation.smax`` around :func:`max_supersaturation` (around the
kernel's launch on the card, which computes it), a child of both.
Counters (always on): ``activation.points``, the points of each
:func:`N_activated_per_mode` call (the activated number, which a host asks
for once a step, with or without the mass); ``activation.mode_points``,
those points times the modes; ``activation.smax_points``, the points whose
maximum supersaturation was computed; ``activation.kernel_points``, the
points of each :func:`N_activated_per_mode` call the kernel stepped
(``kernel_points / points`` is the share of the number calls that ran on
the kernel). A host that asks for the number and the mass computes S_max
twice: ``smax_points / points`` is 2.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import trace
from ..parameters.aerosol import (
    AerosolActivationParameters,
    AerosolDistribution,
    ModeB,
    ModeKappa,
)
from ..parameters.common import AirProperties
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import asarray, float_dtype, floatmin, machine_eps
from . import common as CO
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = [
    "coeff_of_curvature",
    "mean_hygroscopicity_parameter",
    "critical_supersaturation",
    "max_supersaturation",
    "N_activated_per_mode",
    "N_activated_per_mode_plain",
    "M_activated_per_mode",
    "M_activated_per_mode_plain",
    "total_N_activated",
    "total_M_activated",
]


def coeff_of_curvature(ap: AerosolActivationParameters, T):
    """Kelvin curvature coefficient A
    (reference src/AerosolActivation.jl:35-40)."""
    return 2 * ap.sigma * ap.M_w / ap.rho_w / ap.R / T


def mean_hygroscopicity_parameter(ap: AerosolActivationParameters,
                                  ad: AerosolDistribution):
    """Per-mode hygroscopicity: mass-weighted B (Mode_B) or volume-weighted
    kappa (Mode_kappa) (reference src/AerosolActivation.jl:55-95)."""
    out = []
    for mode in ad.modes:
        if isinstance(mode, ModeB):
            nom = sum(
                m * d * o * s / mm
                for m, d, o, s, mm in zip(
                    mode.mass_mix_ratio, mode.dissoc, mode.osmotic_coeff,
                    mode.soluble_mass_frac, mode.molar_mass)
            )
            den = sum(
                m / rho for m, rho in zip(mode.mass_mix_ratio,
                                          mode.aerosol_density))
            out.append(nom / den * ap.M_w / ap.rho_w)
        elif isinstance(mode, ModeKappa):
            out.append(sum(v * k for v, k in zip(mode.vol_mix_ratio,
                                                 mode.kappa)))
        else:
            raise TypeError(f"unknown mode type {type(mode)}")
    return tuple(out)


def critical_supersaturation(ap: AerosolActivationParameters,
                             ad: AerosolDistribution, T):
    """Per-mode critical supersaturation
    (reference src/AerosolActivation.jl:107-118)."""
    A = coeff_of_curvature(ap, T)
    hygro = mean_hygroscopicity_parameter(ap, ad)
    return tuple(
        2 / torch.sqrt(asarray(h, T)) * (A / 3 / mode.r_dry) ** 1.5
        for h, mode in zip(hygro, ad.modes)
    )


def max_supersaturation(ap: AerosolActivationParameters,
                        ad: AerosolDistribution, aip: AirProperties,
                        tps: TPS, T, p, w, q_tot, q_liq, q_ice,
                        N_liq=0.0, N_ice=0.0):
    """Maximum supersaturation: ARG eq 11/12 + Korolev-Mazin alpha/gamma +
    liquid/ice condensation-sink correction
    (reference src/AerosolActivation.jl:138-200)."""
    with trace.span("activation.smax"):
        S_max = _max_supersaturation(ap, ad, aip, tps, T, p, w, q_tot,
                                     q_liq, q_ice, N_liq, N_ice)
    trace.count("activation.smax_points", S_max.numel())
    return S_max


def _max_supersaturation(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                         N_liq, N_ice):
    eps = machine_eps(float_dtype(T, p, w))
    R_v = tps.R_v
    R_m = TDI.gas_constant_air(tps, q_tot, q_liq, q_ice)
    cp_m = TDI.cp_m(tps, q_tot, q_liq, q_ice)
    Lv = TDI.latent_heat_vapor(tps, T)
    rho_air = TDI.air_density(tps, T, p, q_tot, q_liq, q_ice)
    p_v = (q_tot - q_liq - q_ice) * rho_air * R_v * T
    p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T)
    G = CO.G_func_liquid(aip, tps, T) / ap.rho_w

    alpha = p_v / p_vs * (Lv * ap.g / R_v / cp_m / T**2 - ap.g / R_m / T)
    gamma = (R_v * T / p_vs
             + p_v / p_vs * R_m * Lv**2 / R_v / cp_m / T / p)

    A = coeff_of_curvature(ap, T)
    sqrt_awG = torch.sqrt(alpha * w / G)
    zeta = 2 * A / 3 * sqrt_awG

    Sm = critical_supersaturation(ap, ad, T)

    tmp = torch.zeros_like(T)
    for Sm_i, mode in zip(Sm, ad.modes):
        log_stdev = torch.log(asarray(mode.stdev, T))
        f = ap.f1 * torch.exp(ap.f2 * log_stdev ** 2)
        g = ap.g1 + ap.g2 * log_stdev
        eta = sqrt_awG**3 / (2 * PI * ap.rho_w * gamma * mode.N)
        tmp = tmp + 1 / Sm_i**2 * (
            f * (zeta / eta) ** ap.p1
            + g * (Sm_i**2 / (eta + 3 * zeta)) ** ap.p2
        )
    S_max_ARG = 1 / torch.sqrt(tmp)

    # condensation-sink corrections from preexisting liquid / ice
    N_liq = asarray(N_liq, T)
    N_ice = asarray(N_ice, T)
    N_liq_safe = torch.clamp(N_liq, min=eps)
    r_liq = torch.where(
        N_liq < eps, torch.zeros_like(T),
        (rho_air * q_liq / N_liq_safe / ap.rho_w / (4 / 3 * PI)) ** (1 / 3))
    K_liq = 4 * PI * ap.rho_w * N_liq * r_liq * G * gamma

    Ls = TDI.latent_heat_sublim(tps, T)
    gamma_i = (R_v * T / p_vs
               + p_v / p_vs * R_m * Lv * Ls / R_v / cp_m / T / p)
    N_ice_safe = torch.clamp(N_ice, min=eps)
    r_ice = torch.where(
        N_ice < eps, torch.zeros_like(T),
        (rho_air * q_ice / N_ice_safe / ap.rho_i / (4 / 3 * PI)) ** (1 / 3))
    rhoG_i = CO.G_func_ice(aip, tps, T)
    xi = (TDI.saturation_vapor_pressure_over_liquid(tps, T)
          / TDI.saturation_vapor_pressure_over_ice(tps, T))
    K_ice = 4 * PI * N_ice * r_ice * rhoG_i * gamma_i

    S_max = S_max_ARG * (alpha * w - K_ice * (xi - 1)) / (
        alpha * w + (K_liq + K_ice * xi) * S_max_ARG)
    return torch.clamp(S_max, min=0.0)


def _per_mode_u(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice, N_liq,
                N_ice):
    """``(critical supersaturations, guarded maximum supersaturation)``."""
    smax = max_supersaturation(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                               q_ice, N_liq, N_ice)
    smax_safe = torch.clamp(smax, min=floatmin(smax.dtype))
    return critical_supersaturation(ap, ad, T), smax_safe


def _on_card(ad, air) -> bool:
    """Whether any tensor among the air and the modes' fields lies on a
    CUDA device: the kernel's path."""
    values = list(air)
    for mode in ad.modes:
        for f in dataclasses.fields(mode):
            v = getattr(mode, f.name)
            values += v if isinstance(v, tuple) else (v,)
    return any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
               for v in values)


def _kernel():
    from ..kernels import activation

    return activation


def N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                         N_liq=0.0, N_ice=0.0):
    """Per-mode activated number via erf
    (reference src/AerosolActivation.jl:235-259)."""
    air = (T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice)
    with trace.span("activation.number"):
        if _on_card(ad, air):
            out = _kernel().activated(ap, ad, aip, tps, air, mass=False)
            points = out[0].numel()
            trace.count("activation.kernel_points", points)
        else:
            out = N_activated_per_mode_plain(ap, ad, aip, tps, T, p, w, q_tot,
                                             q_liq, q_ice, N_liq, N_ice)
            points = out[0].numel() if out else T.numel()
    trace.count("activation.points", points)
    trace.count("activation.mode_points", points * len(out))
    return out


def N_activated_per_mode_plain(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                               q_ice, N_liq=0.0, N_ice=0.0):
    """:func:`N_activated_per_mode` in eager PyTorch: the plain version."""
    sm, smax_safe = _per_mode_u(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                q_ice, N_liq, N_ice)
    sqrt2 = torch.sqrt(asarray(2.0, smax_safe))
    out = []
    for sm_i, mode in zip(sm, ad.modes):
        u_i = (2 * torch.log(sm_i / smax_safe) / 3 / sqrt2
               / torch.log(asarray(mode.stdev, smax_safe)))
        out.append(mode.N * 0.5 * (1 - torch.special.erf(u_i)))
    return tuple(out)


def M_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                         N_liq=0.0, N_ice=0.0):
    """Per-mode activated mass via erfc
    (reference src/AerosolActivation.jl:294-321)."""
    air = (T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice)
    with trace.span("activation.mass"):
        if _on_card(ad, air):
            return _kernel().activated(ap, ad, aip, tps, air, mass=True)
        return M_activated_per_mode_plain(ap, ad, aip, tps, T, p, w, q_tot,
                                          q_liq, q_ice, N_liq, N_ice)


def M_activated_per_mode_plain(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                               q_ice, N_liq=0.0, N_ice=0.0):
    """:func:`M_activated_per_mode` in eager PyTorch: the plain version."""
    sm, smax_safe = _per_mode_u(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                q_ice, N_liq, N_ice)
    sqrt2 = torch.sqrt(asarray(2.0, smax_safe))
    out = []
    for sm_i, mode in zip(sm, ad.modes):
        M_i = sum(mm * mr for mm, mr in zip(mode.molar_mass,
                                            mode.mass_mix_ratio))
        fac = 3 * torch.log(asarray(mode.stdev, smax_safe)) * sqrt2 / 2
        u_i = torch.log(sm_i / smax_safe) / fac
        out.append(M_i / 2 * torch.special.erfc(u_i - fac))
    return tuple(out)


def total_N_activated(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                      N_liq=0.0, N_ice=0.0):
    return sum(N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                    q_ice, N_liq, N_ice))


def total_M_activated(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                      N_liq=0.0, N_ice=0.0):
    return sum(M_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                    q_ice, N_liq, N_ice))
