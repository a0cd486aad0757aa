"""2-moment + P3 ice tendencies.

Port of ``cloudmicrophysics_tpu/models/p3_tendencies.py`` (reference
``src/BulkMicrophysicsTendencies.jl:898-1083``): the P3 ice processes added
to the SB2006 warm-rain tendencies — liquid-ice collisions, ice
self-collection, melting, F23 deposition nucleation, F23-capped Bigg
immersion freezing, sublimation/deposition relaxation with rime drain,
ice number adjustment, and Bigg rain freezing.

``loglambda`` is an input (solved outside, as the reference's substepping
contract has it). The reference gates the collision block behind
``q_ice > eps``; here it is computed on a sanitized state in every cell
and masked, the branchless equivalent. The step-shared context
(:class:`P3StepAux`) is computed once and passed on; the JAX package pins
it with an XLA ``optimization_barrier``, which an eager step does not need.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import ice_nucleation as CM_HetIce
from ..ops import m2 as CM2
from ..ops import p3 as P3
from ..ops import p3_processes as P3P
from ..ops import thermo as TDI
from ..ops.noneq import _relaxation_tendency, dqcld_dT, gamma_helper
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import (
    clamp_to_nonneg,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    float_dtype,
)
from .tendencies import Tendencies2M

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = ["P3StepAux", "ice_tendencies_2m_p3", "p3_step_aux"]


def _subdep_rate(tau, tps, rho, T, q_tot, q_lcl, q_rai, q_ice):
    """Constant-timescale ice deposition/sublimation relaxation (reference
    CMNonEq._conv_q_vap_to_q_icl_const without the INP limiter; the caller
    applies its own above-freezing clamp)."""
    Rv = tps.R_v
    Ls = TDI.latent_heat_sublim(tps, T)
    cp_air = TDI.cp_m(tps, q_tot, q_lcl + q_rai, q_ice)
    qv = TDI.q_vap(q_tot, q_lcl + q_rai, q_ice)
    qv_sat = TDI.saturation_vapor_specific_content_over_ice(tps, T, rho)
    Gamma_i = gamma_helper(Ls, cp_air, dqcld_dT(qv_sat, Ls, Rv, T))
    timescale = tau * Gamma_i
    return _relaxation_tendency(qv - qv_sat, q_ice, timescale, timescale)


class P3StepAux(NamedTuple):
    """Step-shared sanitized P3 evaluation context.

    Built once per step (:func:`p3_step_aux`) and read by the tendency
    assembly and the column step's sedimentation velocities: one state
    construction, one bounds solve, one velocity/PSD node-table evaluation
    for everything that contracts the ice PSD.
    """

    state: P3.P3State         # sanitized P3State
    loglam: torch.Tensor      # sanitized log lambda
    has_ice: torch.Tensor     # mask of cells with real ice
    nodes: P3.IceQuadNodes    # node table on the sanitized state


def p3_step_aux(mp, rho, q_ice, n_ice, q_rim, b_rim,
                log_lambda) -> P3StepAux:
    """Sanitized state + shared quadrature nodes for one P3 step.

    Placeholder values keep every intermediate finite where ice is absent;
    consumers mask with ``has_ice`` (the branchless equivalent of the
    reference's ``q_ice > eps`` gate)."""
    dt = float_dtype(rho, q_ice)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    q_ice = clamp_to_nonneg(q_ice)
    n_ice = clamp_to_nonneg(n_ice)
    L_ice, N_ice = q_ice * rho, n_ice * rho
    L_rim, B_rim = clamp_to_nonneg(q_rim) * rho, clamp_to_nonneg(b_rim) * rho
    has_ice = (q_ice > em) & (n_ice > en)
    zero = torch.zeros_like(L_ice)
    L_ice_s = torch.where(has_ice, L_ice, torch.full_like(L_ice, 1e-6))
    N_ice_s = torch.where(has_ice, N_ice, torch.full_like(N_ice, 1e3))
    L_rim_s = torch.where(has_ice, L_rim, zero)
    B_rim_s = torch.where(has_ice, B_rim, zero)
    loglam_s = torch.where(has_ice & torch.isfinite(log_lambda), log_lambda,
                           torch.full_like(log_lambda, 8.0))
    state = P3.state_from_prognostic(mp.ice.scheme, L_ice_s, N_ice_s,
                                     L_rim_s, B_rim_s)
    nodes = P3.ice_quadrature_nodes(mp.ice.terminal_velocity, rho, state,
                                    loglam_s, p=1e-6, quad=mp.ice.quad)
    return P3StepAux(state=state, loglam=loglam_s, has_ice=has_ice,
                     nodes=nodes)


def ice_tendencies_2m_p3(
    mp, tps: TPS, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
    q_ice, n_ice, q_rim, b_rim, log_lambda, inpc_log_shift, warm,
    aux: P3StepAux = None,
) -> Tendencies2M:
    """Add the P3 ice tendencies to precomputed warm-rain tendencies
    ``warm = (dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt)``."""
    dt = float_dtype(rho, T)
    em = eps_numerics_2M_M(dt)
    zero = torch.zeros_like(rho * T)

    def as_field(v):
        return zero if v is None else torch.as_tensor(v, dtype=dt,
                                                      device=zero.device)

    q_ice = zero if q_ice is None else clamp_to_nonneg(q_ice)
    n_ice = zero if n_ice is None else clamp_to_nonneg(n_ice)
    q_rim = zero if q_rim is None else clamp_to_nonneg(q_rim)
    b_rim = zero if b_rim is None else clamp_to_nonneg(b_rim)
    log_lambda = as_field(log_lambda)
    inpc_log_shift = as_field(inpc_log_shift)

    dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt = warm

    ice = mp.ice
    p3 = ice.scheme
    vel = ice.terminal_velocity
    pdf_c, pdf_r = ice.cloud_pdf, ice.rain_pdf
    quad = ice.quad

    # volumetric quantities
    L_lcl, L_rai = q_lcl * rho, q_rai * rho
    N_lcl, N_rai = n_lcl * rho, n_rai * rho

    if aux is None:
        aux = p3_step_aux(mp, rho, q_ice, n_ice, q_rim, b_rim, log_lambda)
    state, loglam_s, has_ice, ice_nodes = (
        aux.state, aux.loglam, aux.has_ice, aux.nodes)

    dq_ice_dt = zero
    dn_ice_dt = zero
    dq_rim_dt = zero
    db_rim_dt = zero

    def mask(v):
        return torch.where(has_ice, v, zero)

    # --- liquid-ice collisions (masked) ---
    coll = P3P.bulk_liquid_ice_collision_sources(
        state, loglam_s, pdf_c, pdf_r, L_lcl, N_lcl, L_rai, N_rai,
        mp.warm_rain.air_properties, tps, vel, rho, T, quad=quad,
        ice_nodes=ice_nodes)
    dq_lcl_dt = dq_lcl_dt + mask(coll.dq_c)
    dq_rai_dt = dq_rai_dt + mask(coll.dq_r)
    dn_lcl_dt = dn_lcl_dt + mask(coll.dN_c) / rho
    dn_rai_dt = dn_rai_dt + mask(coll.dN_r) / rho
    dq_ice_dt = dq_ice_dt + mask(coll.dL_ice) / rho
    dq_rim_dt = dq_rim_dt + mask(coll.dL_rim) / rho
    db_rim_dt = db_rim_dt + mask(coll.dB_rim) / rho

    # --- ice self-collection (aggregation) ---
    agg = P3P.ice_self_collection(state, loglam_s, vel, rho, quad=quad,
                                  nodes=ice_nodes)
    dn_ice_dt = dn_ice_dt - mask(agg) / rho

    # --- melting (above freezing) ---
    melt_dN, melt_dL = P3P.ice_melt(vel, mp.warm_rain.air_properties, tps,
                                    T, rho, state, loglam_s, quad=quad,
                                    nodes=ice_nodes)
    melting = has_ice & (T > tps.T_freeze)
    dq_ice_melt = torch.where(melting, melt_dL, zero) / rho
    dn_ice_melt = torch.where(melting, melt_dN, zero) / rho
    dq_rai_dt = dq_rai_dt + dq_ice_melt
    dn_rai_dt = dn_rai_dt + dn_ice_melt
    dq_ice_dt = dq_ice_dt - dq_ice_melt
    dn_ice_dt = dn_ice_dt - dn_ice_melt
    has_rim = state.rho_rim > 0
    rho_rim_safe = torch.where(has_rim, state.rho_rim,
                               torch.ones_like(state.rho_rim))
    dq_rim_dt = dq_rim_dt - dq_ice_melt * state.F_rim
    db_rim_dt = db_rim_dt - torch.where(
        has_rim, dq_ice_melt * state.F_rim / rho_rim_safe, zero)

    # --- F23 deposition nucleation (vapor -> pristine ice); the INPC
    # climatology comes from the params tree (reference mp.ice.ice_nucleation)
    f23 = ice.ice_nucleation
    tau_act = ice.inp_depletion_model.tau_act
    D_nuc = 10e-6
    m_nuc = p3.rho_i * PI / 6 * D_nuc**3
    n_active = CM_HetIce.n_active(ice.inp_depletion_model, n_ice)
    dep_n, dep_q = CM_HetIce.deposition_rate_frostenberg(
        f23, tps, T, rho, q_tot, q_lcl + q_rai, q_ice, n_active,
        m_nuc, tau_act=tau_act, inpc_log_shift=inpc_log_shift)
    dn_ice_dt = dn_ice_dt + dep_n
    dq_ice_dt = dq_ice_dt + dep_q

    # --- F23-capped Bigg immersion freezing of cloud droplets ---
    cld_n, cld_q = CM_HetIce.liquid_freezing_rate_cloud(
        ice.rain_freezing, pdf_c, tps, q_lcl, rho, N_lcl, T)
    cap = CM_HetIce.immersion_limit_rate(
        f23, T, rho, tau=tau_act, inpc_log_shift=inpc_log_shift,
        n_active_proxy=n_active)
    dn_imm = torch.minimum(cld_n, cap)
    freezing = cld_n > 0
    cld_n_safe = torch.where(freezing, cld_n, torch.ones_like(cld_n))
    dq_imm = torch.where(freezing, cld_q * dn_imm / cld_n_safe, zero)
    dq_lcl_dt = dq_lcl_dt - dq_imm
    dn_lcl_dt = dn_lcl_dt - dn_imm
    dq_ice_dt = dq_ice_dt + dq_imm
    dn_ice_dt = dn_ice_dt + dn_imm
    dq_rim_dt = dq_rim_dt + dq_imm           # frozen drop: F_rim = 1
    db_rim_dt = db_rim_dt + dq_imm / p3.rho_i

    # --- ice sublimation / deposition relaxation ---
    some_ice = q_ice > em
    q_ice_safe = torch.where(some_ice, q_ice, torch.ones_like(q_ice))
    n_per_q = torch.where(some_ice, n_ice / q_ice_safe, zero)
    dq_dep = _subdep_rate(mp.warm_rain.subdep.tau_relax, tps, rho, T,
                          q_tot, q_lcl, q_rai, q_ice)
    dq_dep = torch.where(T > tps.T_freeze, torch.minimum(dq_dep, zero),
                         dq_dep)
    dn_dep = torch.where(dq_dep < 0, n_per_q * dq_dep, zero)
    dq_ice_dt = dq_ice_dt + dq_dep
    dn_ice_dt = dn_ice_dt + dn_dep
    dq_sub = torch.minimum(dq_dep, zero)
    dq_rim_dt = dq_rim_dt + dq_sub * state.F_rim
    db_rim_dt = db_rim_dt + torch.where(
        has_rim, dq_sub * state.F_rim / rho_rim_safe, zero)

    # --- ice number adjustment (mass limits; reference
    # BulkMicrophysicsTendencies.jl:1056-1064) ---
    na = ice.numadj
    dn_ice_dt = dn_ice_dt + CM2.number_tendency_from_mass_limits(
        na.x_min, na.x_max, na.tau, q_ice, n_ice)

    # --- Bigg rain freezing (fully rimed) ---
    rf_n, rf_q = CM_HetIce.liquid_freezing_rate_rain(
        ice.rain_freezing, pdf_r, tps, q_rai, rho, N_rai, T)
    dq_rai_dt = dq_rai_dt - rf_q
    dn_rai_dt = dn_rai_dt - rf_n
    dq_ice_dt = dq_ice_dt + rf_q
    dn_ice_dt = dn_ice_dt + rf_n
    dq_rim_dt = dq_rim_dt + rf_q
    db_rim_dt = db_rim_dt + rf_q / p3.rho_i

    return Tendencies2M(dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt,
                        dq_ice_dt, dn_ice_dt, dq_rim_dt, db_rim_dt)
