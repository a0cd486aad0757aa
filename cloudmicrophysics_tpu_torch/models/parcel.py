"""Adiabatic parcel model (L6 driver).

Port of ``cloudmicrophysics_tpu/models/parcel.py`` (reference
``parcel/``): the 10-variable ODE system ``[S_l, p, T, q_vap, q_liq,
q_ice, N_aer, N_liq, N_ice, ln_INPC]``, Euler-stepped, with the processes
chosen by static strings (reference ``parcel/ParcelTendencies.jl``):

* aerosol activation (ARG critical-supersaturation form),
* deposition nucleation (MohlerAF / MohlerRate / ABDINM / P3_dep),
* immersion freezing (ABIFM / P3_het / Frostenberg mean|random|stochastic),
* homogeneous freezing (ABHOM / P3_hom),
* condensation and deposition growth (classical + non-equilibrium).

An ensemble is a :class:`ParcelState` whose fields have shape ``(N,)``;
the JAX package's ``vmap`` over states becomes broadcasting. Its ``vmap``
over parameters becomes a numeric field of :class:`ParcelParams` (or of
its aerosol struct) holding a tensor of shape ``(N,)``. A step runs where
the state lives, with no wait on the device.

:func:`parcel_step` is one Euler step, the one :func:`run_parcel` loops
over; it is the span ``step.parcel``, with a span for each of its parts
(:mod:`..trace`).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..ops import aerosol_activation as AA
from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..ops import thermo as TDI
from ..parameters.aerosol import AerosolActivationParameters
from ..parameters.common import AirProperties, WaterProperties
from ..parameters.ice_nucleation import (
    Frostenberg2023,
    IceNucleationParameters,
    ice_nucleation_parameters,
)
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.param import paramclass, static_field
from ..utils.special import asarray, float_dtype, floatmin, machine_eps

PI = math.pi

# a host number in a state's float dtype
_HOST_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}

__all__ = ["ParcelState", "ParcelParams", "parcel_params", "parcel_step",
           "parcel_tendencies", "run_parcel", "distribution_moments"]


class ParcelState(NamedTuple):
    """Parcel prognostics, all base SI (reference parcel/ParcelModel.jl:54-76)."""

    S_l: torch.Tensor      # saturation ratio over liquid
    p_air: torch.Tensor    # pressure [Pa]
    T: torch.Tensor        # temperature [K]
    q_vap: torch.Tensor    # vapor specific content [kg/kg]
    q_liq: torch.Tensor    # cloud liquid [kg/kg]
    q_ice: torch.Tensor    # cloud ice [kg/kg]
    N_aer: torch.Tensor    # interstitial aerosol [1/m^3]
    N_liq: torch.Tensor    # droplets [1/m^3]
    N_ice: torch.Tensor    # ice crystals [1/m^3]
    ln_inpc: torch.Tensor  # log INPC (stochastic Frostenberg only)


@paramclass
class ParcelParams:
    """Parcel configuration (reference parcel/ParcelModel.jl:12-42).

    Process choices are static strings; "None" disables a process.
    """

    aerosol_act: str = static_field("None")       # None | AeroAct
    deposition: str = static_field("None")        # None|MohlerAF|MohlerRate|ABDINM|P3_dep
    heterogeneous: str = static_field("None")     # None|ABIFM|P3_het|Frostenberg_{mean,random,stochastic}
    homogeneous: str = static_field("None")       # None|ABHOM|P3_hom
    condensation_growth: str = static_field("None")   # None|Condensation|NonEq_Condensation[_simple]
    deposition_growth: str = static_field("None")     # None|Deposition|NonEq_Deposition[_simple]
    liq_size_distribution: str = static_field("Monodisperse")  # Monodisperse|Gamma
    ice_size_distribution: str = static_field("Monodisperse")

    aerosol: object = None          # species struct (kappa, M, ABIFM m/c, ...)
    aero_sigma_g: float = 0.0
    wps: WaterProperties = None
    aps: AirProperties = None
    tps: ThermodynamicsParameters = None
    aap: AerosolActivationParameters = None
    ips: IceNucleationParameters = None
    ip: Frostenberg2023 = None      # Frostenberg INPC distribution
    const_dt: float = 1.0
    w: float = 1.0                  # updraft [m/s]
    r_nuc: float = 0.5 * 1e-4 * 1e-6
    A_aer: float = 1e-9
    sampling_interval: float = 1.0
    gamma: float = 1.0              # OU inverse timescale
    noneq_tau: float = 10.0         # NonEq growth relaxation timescale [s]
    N_aer_act: float = 1e8          # AeroAct mode number


@trace.timed("setup.params_s")
def parcel_params(**kw) -> ParcelParams:
    kw.setdefault("wps", WaterProperties())
    kw.setdefault("aps", AirProperties())
    kw.setdefault("tps", ThermodynamicsParameters())
    kw.setdefault("aap", AerosolActivationParameters())
    kw.setdefault("ips", ice_nucleation_parameters())
    kw.setdefault("ip", Frostenberg2023())
    return ParcelParams(**kw)


def distribution_moments(kind: str, q, N, rho, rho_air):
    """Mean radius / area / volume for the assumed PSD
    (reference parcel/ParcelDistributions.jl:11-76)."""
    tiny = floatmin(float_dtype(q, N))
    empty = (N <= 0) | (q <= 0)
    N_s = torch.clamp(N, min=tiny)
    q_s = torch.clamp(q, min=tiny)
    if kind == "Monodisperse":
        r = (q_s / N_s / (4 / 3 * PI) / rho * rho_air) ** (1 / 3)
        A = 4 * PI * r**2
        V = 4 / 3 * PI * r**3
    elif kind == "Gamma":
        lam = (32 * PI * N_s / q_s * rho / rho_air) ** (1 / 3)
        r = 2 / lam
        A = 4 * PI * 6 / lam**2
        V = 4 / 3 * PI * 24 / lam**3
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    z = torch.zeros_like(r)
    return (torch.where(empty, z, r), torch.where(empty, z, A),
            torch.where(empty, z, V))


def _xi(tps, T):
    """Saturation-pressure ratio liquid/ice (reference parcel/ParcelCommon.jl:4)."""
    return (TDI.saturation_vapor_pressure_over_liquid(tps, T)
            / TDI.saturation_vapor_pressure_over_ice(tps, T))


def _limit(q, dt_step):
    return q / dt_step


def _clip(x):
    return torch.clamp(x, min=0.0)


def _limited_growth(raw, q_vap, q_cond, dt_step):
    """A growth rate limited by the vapor available (growth) or by the
    condensate available (loss)."""
    return torch.where(
        raw > 0,
        torch.minimum(raw, _limit(q_vap, dt_step)),
        -torch.minimum(torch.abs(raw), _limit(q_cond, dt_step)))


def parcel_tendencies(params: ParcelParams, y: ParcelState, t,
                      dS_l_dt_prev, rng_normal=None):
    """All parcel tendencies (reference parcel/ParcelModel.jl:54-187).

    ``dS_l_dt_prev`` supplies the previous-step dS/dt for the MohlerRate
    deposition variant (the reference reads dY[1] in-place).
    ``rng_normal`` is a pair of standard-normal draws (a tensor of shape
    ``(2,)``) for the stochastic Frostenberg variants. ``t`` is a host
    number (taken in the state's float dtype) or a tensor.
    """
    return _tendencies(params, y, t, dS_l_dt_prev, rng_normal, False)


def parcel_step(params: ParcelParams, y: ParcelState, t, dS_prev,
                draws=None):
    """One Euler step of the parcel ODE, the step :func:`run_parcel` loops
    over: ``(y_next, dS_l)``, the state at ``t + const_dt`` and this step's
    dS_l/dt, which is the next step's ``dS_prev``. ``draws``: the step's
    pair of standard normals (:func:`parcel_tendencies`' ``rng_normal``).

    The span ``step.parcel`` holds ``parcel.thermo`` (clipping,
    thermodynamics, saturation ratios, size moments), one span for each
    enabled process family (``parcel.activation``, ``parcel.deposition``,
    ``parcel.immersion``, ``parcel.homogeneous``,
    ``parcel.condensation_growth``, ``parcel.deposition_growth``) and
    ``parcel.update`` (the budgets and the Euler update).
    """
    with trace.span("step.parcel"):
        return _tendencies(params, y, t, dS_prev, draws, True)


def _family(name: str, mode: str):
    """The span ``name`` of a process family, when its ``mode`` enables
    it: a disabled family's block (its zero rates) has no span."""
    return trace.span(name) if mode != "None" else contextlib.nullcontext()


def _tendencies(params, y, t, dS_l_dt_prev, rng_normal, euler: bool):
    """The tendencies of ``y``; with ``euler``, ``(y_next, dS_l)`` of one
    Euler step instead."""
    # thermodynamics and size moments
    with trace.span("parcel.thermo"):
        tps, aps, wps = params.tps, params.aps, params.wps
        dt = float_dtype(y.T)
        eps = machine_eps(dt)
        tiny = floatmin(dt)
        dt_step = params.const_dt

        S_l, p_air, T = y.S_l, y.p_air, y.T
        q_vap, q_liq, q_ice = _clip(y.q_vap), _clip(y.q_liq), _clip(y.q_ice)
        N_aer, N_liq, N_ice = _clip(y.N_aer), _clip(y.N_liq), _clip(y.N_ice)

        rho_i, rho_l = wps.rho_i, wps.rho_w
        Rv = tps.R_v
        q_tot = q_vap + q_liq + q_ice
        R_air = TDI.gas_constant_air(tps, q_tot, q_liq, q_ice)
        cp_air = TDI.cp_m(tps, q_tot, q_liq, q_ice)
        L_subl = TDI.latent_heat_sublim(tps, T)
        L_fus = TDI.latent_heat_fusion(tps, T)
        L_vap = TDI.latent_heat_vapor(tps, T)
        rho_air = TDI.air_density(tps, T, p_air, q_tot, q_liq, q_ice)

        e = q_vap * p_air * Rv / R_air
        e_sl = TDI.saturation_vapor_pressure_over_liquid(tps, T)

        r_liq, A_liq, V_liq = distribution_moments(
            params.liq_size_distribution, q_liq, N_liq, rho_l, rho_air)
        r_ice, A_ice, V_ice = distribution_moments(
            params.ice_size_distribution, q_ice, N_ice, rho_i, rho_air)

        zero = torch.zeros_like(T)
        xi = _xi(tps, T)
        S_i = xi * S_l

    # --- Aerosol activation (reference parcel/ParcelTendencies.jl:15-41) ---
    with _family("parcel.activation", params.aerosol_act):
        if params.aerosol_act == "None":
            dN_liq_act = zero
        elif params.aerosol_act == "AeroAct":
            A_curv = AA.coeff_of_curvature(params.aap, T)
            sm = 2 / torch.sqrt(asarray(params.aerosol.kappa, T)) \
                * (A_curv / 3 / params.r_nuc) ** 1.5
            smax = torch.clamp(S_l - 1, min=tiny)
            u = 2 * torch.log(sm / smax) / 3 / torch.sqrt(asarray(2.0, T)) \
                / torch.log(asarray(params.aero_sigma_g, T))
            n_act = params.N_aer_act * 0.5 * (1 - torch.special.erf(u))
            dN_liq_act = _clip(n_act - (params.N_aer_act - N_aer))
        else:
            raise ValueError(
                f"unknown aerosol activation {params.aerosol_act!r}")

        r_act_raw = 2 / 3 * AA.coeff_of_curvature(params.aap, T) \
            / torch.clamp(S_l - 1, min=tiny)
        r_act = torch.where(
            (dN_liq_act < eps) | ((S_l - 1) < eps),
            asarray(params.r_nuc, T),
            torch.clamp(r_act_raw, max=1e-6))
        dq_liq_act = dN_liq_act * 4 * PI / 3 * r_act**3 * rho_l / rho_air

    # --- Deposition nucleation (reference ParcelTendencies.jl:43-113) ---
    with _family("parcel.deposition", params.deposition):
        if params.deposition == "None":
            dN_ice_dep = zero
        elif params.deposition == "MohlerAF":
            AF = CMI.dust_activated_number_fraction(
                params.aerosol, params.ips.deposition, S_i, T)
            AF = torch.where(S_i >= params.ips.deposition.Si_max, zero, AF)
            dN_ice_dep = _clip(AF * N_aer - N_ice) / dt_step
        elif params.deposition == "MohlerRate":
            dSi_dt = xi * dS_l_dt_prev
            rate = CMI.mohler_deposition_rate(
                params.aerosol, params.ips.deposition, S_i, T, dSi_dt, N_aer)
            rate = torch.where(S_i >= params.ips.deposition.Si_max, zero, rate)
            dN_ice_dep = torch.minimum(_clip(rate), N_aer / dt_step)
        elif params.deposition == "ABDINM":
            da_w = CMO.a_w_eT(tps, e, T) - CMO.a_w_ice(tps, T)
            J = CMI.deposition_J(params.aerosol, da_w)
            A_nuc = 4 * PI * params.r_nuc**2
            dN_ice_dep = torch.minimum(J * N_aer * A_nuc, N_aer / dt_step)
        elif params.deposition == "P3_dep":
            N_dep = CMI.P3_deposition_N_i(params.ips.p3, T)
            dN_ice_dep = torch.minimum(_clip((N_dep - N_ice) / dt_step),
                                       N_aer / dt_step)
        else:
            raise ValueError(f"unknown deposition mode {params.deposition!r}")
        dq_ice_dep = (dN_ice_dep * 4 / 3 * PI * params.r_nuc**3 * rho_i
                      / rho_air)

    # --- Immersion freezing (reference ParcelTendencies.jl:115-213) ---
    with _family("parcel.immersion", params.heterogeneous):
        dln_inpc = zero
        if params.heterogeneous == "None":
            dN_ice_imm = zero
        elif params.heterogeneous == "ABIFM":
            da_w = CMO.a_w_eT(tps, e, T) - CMO.a_w_ice(tps, T)
            J = CMI.ABIFM_J(params.aerosol, da_w)
            dN_ice_imm = torch.minimum(J * N_liq * params.A_aer,
                                       N_liq / dt_step)
        elif params.heterogeneous == "P3_het":
            N_het = CMI.P3_het_N_i(params.ips.p3, T, N_liq, V_liq, dt_step)
            dN_ice_imm = torch.minimum(_clip((N_het - N_ice) / dt_step),
                                       N_liq / dt_step)
        elif params.heterogeneous == "Frostenberg_mean":
            INPC = torch.exp(CMI.INP_concentration_mean(params.ip, T))
            dN_ice_imm = torch.minimum(N_liq, _clip(INPC - N_ice)) / dt_step
        elif params.heterogeneous == "Frostenberg_random":
            mu = CMI.INP_concentration_mean(params.ip, T)
            draw = torch.exp(mu + params.ip.sigma * rng_normal[0])
            interval = params.sampling_interval
            if isinstance(t, torch.Tensor) or isinstance(interval,
                                                         torch.Tensor):
                sample_now = torch.remainder(t, interval) == 0
                INPC = torch.where(sample_now, draw, zero)
            else:
                # a host time decides on the host, in the state's float dtype:
                # jnp.mod's in the JAX package's default float (float32
                # without x64)
                f = _HOST_FLOAT[dt]
                INPC = draw if f(t) % f(interval) == 0 else zero
            dN_ice_imm = torch.minimum(N_liq, _clip(INPC - N_ice)) / dt_step
        elif params.heterogeneous == "Frostenberg_stochastic":
            mu = CMI.INP_concentration_mean(params.ip, T)
            g = params.ip.sigma * torch.sqrt(asarray(2 * params.gamma, T))
            dln_inpc = (-params.gamma * (y.ln_inpc - mu) * dt_step
                        + g * torch.sqrt(asarray(dt_step, T)) * rng_normal[1]
                        ) / dt_step
            dN_ice_imm = torch.minimum(
                N_liq, _clip(torch.exp(y.ln_inpc) - N_ice)) / dt_step
        else:
            raise ValueError(
                f"unknown heterogeneous mode {params.heterogeneous!r}")
        dq_ice_imm = dN_ice_imm * V_liq * rho_i / rho_air

    # --- Homogeneous freezing (reference ParcelTendencies.jl:193-213) ---
    with _family("parcel.homogeneous", params.homogeneous):
        if params.homogeneous == "None":
            dN_ice_hom = zero
        elif params.homogeneous == "ABHOM":
            e_hom = e_sl * S_l
            da_w = CMO.a_w_eT(tps, e_hom, T) - CMO.a_w_ice(tps, T)
            J = CMI.homogeneous_J_linear(params.ips.homogeneous, da_w)
            dN_ice_hom = torch.minimum(J * N_liq * V_liq, N_liq / dt_step)
        elif params.homogeneous == "P3_hom":
            dN_ice_hom = torch.where((T < 233.15) & (N_liq > 0),
                                     N_liq / dt_step, zero)
        else:
            raise ValueError(
                f"unknown homogeneous mode {params.homogeneous!r}")
        dq_ice_hom = dN_ice_hom * V_liq * rho_i / rho_air

    # --- Condensation growth (reference ParcelTendencies.jl:215-245) ---
    with _family("parcel.condensation_growth", params.condensation_growth):
        if params.condensation_growth == "None":
            dq_liq_ce = zero
        elif params.condensation_growth == "Condensation":
            G_l = CMO.G_func_liquid(aps, tps, T)
            raw = 4 * PI / rho_air * (S_l - 1) * G_l * r_liq * N_liq
            dq_liq_ce = _limited_growth(raw, q_vap, q_liq, dt_step)
        elif params.condensation_growth == "NonEq_Condensation_simple":
            # (S_l q_v - q_v - q_l)/tau (reference ParcelTendencies.jl:234-246)
            q_sat_liq = torch.maximum(S_l * q_vap - q_vap, zero)
            dq_liq_ce = (q_sat_liq - q_liq) / params.noneq_tau
        elif params.condensation_growth == "NonEq_Condensation":
            # Morrison-Grabowski Gamma-corrected relaxation
            # (reference ParcelTendencies.jl:248-276)
            from ..ops.noneq import (
                _relaxation_tendency,
                dqcld_dT,
                gamma_helper,
            )

            q_t = q_vap + q_liq + q_ice
            Lv = TDI.latent_heat_vapor(tps, T)
            cp_air = TDI.cp_m(tps, q_t, q_liq, q_ice)
            qv_sat = TDI.saturation_vapor_specific_content_over_liquid(
                tps, T, rho_air)
            Gam = gamma_helper(Lv, cp_air, dqcld_dT(qv_sat, Lv, tps.R_v, T))
            raw = _relaxation_tendency(q_vap - qv_sat, q_liq,
                                       params.noneq_tau * Gam,
                                       params.noneq_tau * Gam)
            dq_liq_ce = _limited_growth(raw, q_vap, q_liq, dt_step)
        else:
            raise ValueError(
                f"unknown condensation growth {params.condensation_growth!r}")
        dN_liq_ce = torch.where(
            (dq_liq_ce < 0) & (q_liq > 0) & (q_liq < 1e-6),
            N_liq * dq_liq_ce / torch.clamp(q_liq, min=tiny), zero)

    # --- Deposition growth (reference ParcelTendencies.jl:278-300) ---
    with _family("parcel.deposition_growth", params.deposition_growth):
        if params.deposition_growth == "None":
            dq_ice_ds = zero
        elif params.deposition_growth == "Deposition":
            G_i = CMO.G_func_ice(aps, tps, T)
            raw = 4 * PI / rho_air * (S_i - 1) * G_i * r_ice * N_ice
            dq_ice_ds = _limited_growth(raw, q_vap, q_ice, dt_step)
        elif params.deposition_growth == "NonEq_Deposition_simple":
            # (S_i q_v - q_v - q_i)/tau (reference ParcelTendencies.jl:298-312)
            q_sat_ice = torch.maximum(S_i * q_vap - q_vap, zero)
            dq_ice_ds = (q_sat_ice - q_ice) / params.noneq_tau
        elif params.deposition_growth == "NonEq_Deposition":
            # Gamma-corrected relaxation with the Frostenberg
            # temperature-dependent deposition timescale
            # (reference ParcelTendencies.jl:314-352)
            from ..ops.noneq import (
                _relaxation_tendency,
                dqcld_dT,
                gamma_helper,
                tau_relax_frostenberg,
            )
            from ..parameters.m1 import cloud_ice as _cloud_ice

            q_t = q_vap + q_liq + q_ice
            Ls = TDI.latent_heat_sublim(tps, T)
            cp_air = TDI.cp_m(tps, q_t, q_liq, q_ice)
            qvi_sat = TDI.saturation_vapor_specific_content_over_ice(
                tps, T, rho_air)
            Gam_i = gamma_helper(Ls, cp_air, dqcld_dT(qvi_sat, Ls, tps.R_v, T))
            tau_dep = tau_relax_frostenberg(_cloud_ice(), aps, params.ip,
                                            q_ice, T)
            raw = _relaxation_tendency(q_vap - qvi_sat, q_ice,
                                       tau_dep * Gam_i,
                                       params.noneq_tau * Gam_i)
            raw = torch.where((T > tps.T_freeze) & (raw > 0), zero, raw)
            dq_ice_ds = _limited_growth(raw, q_vap, q_ice, dt_step)
        else:
            raise ValueError(
                f"unknown deposition growth {params.deposition_growth!r}")
        dN_ice_ds = torch.where(
            (dq_ice_ds < 0) & (q_ice > 0) & (q_ice < 1e-6),
            N_ice * dq_ice_ds / torch.clamp(q_ice, min=tiny), zero)

    # --- Budgets (reference ParcelModel.jl:147-186) ---
    with trace.span("parcel.update"):
        dN_ice = dN_ice_dep + dN_ice_imm + dN_ice_hom + dN_ice_ds
        dN_aer = -dN_ice_dep - dN_liq_act
        dN_liq = dN_liq_act - dN_ice_imm - dN_ice_hom + dN_liq_ce

        dq_liq_v2l = dq_liq_ce + dq_liq_act
        dq_ice_l2i = dq_ice_imm + dq_ice_hom
        dq_ice_v2i = dq_ice_dep + dq_ice_ds

        dq_ice = dq_ice_v2i + dq_ice_l2i
        dq_liq = dq_liq_v2l - dq_ice_l2i
        dq_vap = -dq_liq_v2l - dq_ice_v2i

        grav = tps.grav
        w = params.w
        dp_air = -p_air * grav / R_air / T * w
        dT = (-grav / cp_air * w
              + L_vap / cp_air * dq_liq_v2l
              + L_fus / cp_air * dq_ice_l2i
              + L_subl / cp_air * dq_ice_v2i)

        de = dq_vap * p_air * Rv / R_air + q_vap * dp_air * Rv / R_air
        de_sl = L_vap * e_sl / Rv / T**2 * dT
        dS_l = 1 / e_sl * de - e / e_sl**2 * de_sl

        dy = ParcelState(dS_l, dp_air, dT, dq_vap, dq_liq, dq_ice,
                         dN_aer, dN_liq, dN_ice, dln_inpc)
        if not euler:
            return dy
        return ParcelState(*(v + dt_step * d for v, d in zip(y, dy))), dS_l


def run_parcel(ic: ParcelState, t_0: float, t_end: float,
               params: ParcelParams, rng_key=None, save_every: int = 1):
    """Euler-step the parcel ODE; returns the trajectory (a ParcelState of
    tensors with a leading time axis of ``n_steps + 1``, including t_0).

    ``rng_key`` is a ``torch.Generator`` on the state's device for the
    Frostenberg random and stochastic variants (one seeded 0 when none is
    given); each step draws one pair of standard normals, shared by every
    member of an ensemble. ``save_every`` is accepted and unused, as in
    the JAX package.
    """
    dt_step = params.const_dt
    n_steps = int(round((t_end - t_0) / dt_step))
    needs_rng = params.heterogeneous in ("Frostenberg_random",
                                         "Frostenberg_stochastic")
    device, dtype = ic.T.device, float_dtype(ic.T)
    if needs_rng and rng_key is None:
        rng_key = torch.Generator(device=device).manual_seed(0)

    # lax.scan's stacked outputs with the initial condition prepended: one
    # preallocated (n_steps + 1, *batch) tensor per field, filled in place
    traj = ParcelState(*(torch.empty((n_steps + 1, *v.shape), dtype=v.dtype,
                                     device=v.device) for v in ic))
    for buf, v in zip(traj, ic):
        buf[0] = v
    y, dS_prev = ic, torch.zeros_like(ic.S_l)
    f = _HOST_FLOAT[dtype]
    for i in range(n_steps):
        # the JAX scan's t_0 + i * dt_step, in its default float dtype
        t = f(t_0) + f(i) * f(dt_step)
        draws = (torch.randn((2,), generator=rng_key, dtype=dtype,
                             device=device) if needs_rng else None)
        y, dS_prev = parcel_step(params, y, t, dS_prev, draws)
        for buf, v in zip(traj, y):
            buf[i + 1] = v
    return traj
