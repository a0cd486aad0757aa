"""Fused bulk microphysics tendencies (L5): the 0M, 1M and 2M (warm rain,
and P3 ice when ``mp.ice`` is set) entry points and the scheme dispatcher.

Port of ``cloudmicrophysics_tpu/models/tendencies.py:49-567`` (reference
``src/BulkMicrophysicsTendencies.jl``): all process rates for a scheme in
one elementwise pass over local state; the P3 ice processes live in
:mod:`.p3_tendencies`.

Output modes (reference ``src/BulkMicrophysicsTendencies.jl:85-115``):

* ``instantaneous``          — raw nonlinear tendencies, one evaluation;
* ``instantaneous_verbose``  — plus all ~18 individual source terms;
* ``linearized_average``     — time-averaged tendencies from ``nsub``
  linearized implicit substeps (donor-based linearization, 2x2 block
  solves), the mode used operationally by ClimaAtmos.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import m0 as CM0
from ..ops import m1 as CM1
from ..ops import noneq as CMNonEq
from ..ops import thermo as TDI
from ..ops.states import MicroState, ThermoState
from ..parameters.common import Microphysics0MParams
from ..parameters.m1 import Microphysics1MParams
from ..parameters.m2 import Microphysics2MParams
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import clamp_to_nonneg, float_dtype, machine_eps

TPS = ThermodynamicsParameters

__all__ = [
    "SourceTerms1M",
    "Tendencies1M",
    "Tendencies2M",
    "microphysics_source_terms_1m",
    "aggregate_tendencies_1m",
    "bulk_tendencies_0m",
    "bulk_tendencies_1m",
    "bulk_tendencies_2m",
    "bulk_microphysics_tendencies",
    "warm_rain_tendencies_2m",
]


class SourceTerms1M(NamedTuple):
    """The ~18 individual 1M source terms
    (reference src/BulkMicrophysicsTendencies.jl:141-217).

    Naming: ``S_process_species1_species2``; two-sided collision arms are
    pre-routed by temperature into ``_cold``/``_warm`` (inactive arm = 0).
    """

    S_phase_change_vap_lcl: torch.Tensor
    S_phase_change_vap_icl: torch.Tensor
    S_acnv_lcl_rai: torch.Tensor
    S_acnv_icl_sno: torch.Tensor
    S_accr_lcl_rai: torch.Tensor
    S_accr_lcl_sno_cold: torch.Tensor
    S_accr_lcl_sno_warm: torch.Tensor
    S_accr_melt_lcl_sno: torch.Tensor
    S_accr_icl_rai: torch.Tensor
    S_accr_freeze_icl_rai: torch.Tensor
    S_accr_icl_sno: torch.Tensor
    S_accr_rai_sno_cold: torch.Tensor
    S_accr_rai_sno_warm: torch.Tensor
    S_accr_melt_rai_sno: torch.Tensor
    S_phase_change_vap_rai: torch.Tensor
    S_phase_change_vap_sno: torch.Tensor
    S_melt_icl_lcl: torch.Tensor
    S_melt_sno_rai: torch.Tensor


class Tendencies1M(NamedTuple):
    dq_lcl_dt: torch.Tensor
    dq_icl_dt: torch.Tensor
    dq_rai_dt: torch.Tensor
    dq_sno_dt: torch.Tensor


def microphysics_source_terms_1m(
    mp: Microphysics1MParams, tps: TPS,
    rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno,
    sd=None,
) -> SourceTerms1M:
    """All individual 1M source terms in one pass — the single source of
    truth for process routing
    (reference src/BulkMicrophysicsTendencies.jl:141-217).

    ``sd``: optionally pass precomputed :class:`CM1.SizeDistParams` (the
    column step shares them with the sedimentation velocities)."""
    rho = clamp_to_nonneg(rho)
    q_tot = clamp_to_nonneg(q_tot)
    q_lcl = clamp_to_nonneg(q_lcl)
    q_icl = clamp_to_nonneg(q_icl)
    q_rai = clamp_to_nonneg(q_rai)
    q_sno = clamp_to_nonneg(q_sno)

    micro = MicroState(q_tot, q_lcl, q_icl, q_rai, q_sno)
    thermo = ThermoState(rho, T)

    if sd is None:
        sd = CM1.size_distr_parameters(mp, micro, thermo)

    zero = torch.zeros_like(T)
    is_warm = T >= tps.T_freeze

    S_phase_change_vap_lcl = CMNonEq.conv_q_vap_to_q_lcl(mp, tps, micro, thermo)
    S_phase_change_vap_icl = CMNonEq.conv_q_vap_to_q_icl(mp, tps, micro, thermo)

    S_acnv_lcl_rai = CM1.conv_q_lcl_to_q_rai(mp, tps, micro, thermo) \
        if mp.processes.rain_autoconversion else zero
    S_acnv_icl_sno = CM1.conv_q_icl_to_q_sno(mp, tps, micro, thermo, sd) \
        if mp.processes.snow_autoconversion else zero

    S_accr_lcl_rai = CM1.accretion_cloud_liquid_rain(mp, tps, micro, thermo, sd)

    S_accr, S_melt_ls = CM1.accretion_cloud_liquid_snow(
        mp, tps, micro, thermo, sd)
    S_accr_lcl_sno_cold = torch.where(is_warm, zero, S_accr)
    S_accr_lcl_sno_warm = torch.where(is_warm, S_accr, zero)
    S_accr_melt_lcl_sno = S_melt_ls  # already zero when cold

    S_accr_icl_rai = CM1.accretion_cloud_ice_rain(mp, tps, micro, thermo, sd)
    S_accr_freeze_icl_rai = CM1.accretion_rain_sink(mp, tps, micro, thermo, sd)
    S_accr_icl_sno = CM1.accretion_cloud_ice_snow(mp, tps, micro, thermo, sd)

    S_rai_sno, S_sno_rai, S_melt_rs = CM1.accretion_snow_rain(
        mp, tps, micro, thermo, sd)
    S_accr_rai_sno_cold = torch.where(is_warm, zero, S_rai_sno)
    S_accr_rai_sno_warm = torch.where(is_warm, S_sno_rai, zero)
    S_accr_melt_rai_sno = torch.where(is_warm, S_melt_rs, zero)

    S_phase_change_vap_rai = CM1.conv_q_rai_to_q_vap(mp, tps, micro, thermo, sd)
    S_phase_change_vap_sno = CM1.conv_q_sno_to_q_vap(mp, tps, micro, thermo, sd)

    S_melt_icl_lcl = CM1.conv_q_icl_to_q_lcl(mp, tps, micro, thermo, sd)
    S_melt_sno_rai = CM1.conv_q_sno_to_q_rai(mp, tps, micro, thermo, sd)

    return SourceTerms1M(
        S_phase_change_vap_lcl, S_phase_change_vap_icl,
        S_acnv_lcl_rai, S_acnv_icl_sno,
        S_accr_lcl_rai, S_accr_lcl_sno_cold, S_accr_lcl_sno_warm,
        S_accr_melt_lcl_sno,
        S_accr_icl_rai, S_accr_freeze_icl_rai, S_accr_icl_sno,
        S_accr_rai_sno_cold, S_accr_rai_sno_warm, S_accr_melt_rai_sno,
        S_phase_change_vap_rai, S_phase_change_vap_sno,
        S_melt_icl_lcl, S_melt_sno_rai,
    )


def aggregate_tendencies_1m(src: SourceTerms1M) -> Tendencies1M:
    """Fixed-sign aggregation of source terms into the four hydrometeor
    tendencies (reference src/BulkMicrophysicsTendencies.jl:227-252)."""
    dq_lcl_dt = (
        src.S_phase_change_vap_lcl - src.S_acnv_lcl_rai - src.S_accr_lcl_rai
        - src.S_accr_lcl_sno_cold - src.S_accr_lcl_sno_warm
        + src.S_melt_icl_lcl
    )
    dq_icl_dt = (
        src.S_phase_change_vap_icl - src.S_acnv_icl_sno - src.S_accr_icl_rai
        - src.S_accr_icl_sno - src.S_melt_icl_lcl
    )
    dq_rai_dt = (
        src.S_acnv_lcl_rai + src.S_accr_lcl_rai
        + src.S_accr_lcl_sno_warm + src.S_accr_melt_lcl_sno
        - src.S_accr_freeze_icl_rai
        - src.S_accr_rai_sno_cold + src.S_accr_rai_sno_warm
        + src.S_accr_melt_rai_sno
        + src.S_phase_change_vap_rai + src.S_melt_sno_rai
    )
    dq_sno_dt = (
        src.S_acnv_icl_sno
        + src.S_accr_lcl_sno_cold - src.S_accr_melt_lcl_sno
        + src.S_accr_icl_rai + src.S_accr_freeze_icl_rai
        + src.S_accr_icl_sno
        + src.S_accr_rai_sno_cold - src.S_accr_rai_sno_warm
        - src.S_accr_melt_rai_sno
        + src.S_phase_change_vap_sno - src.S_melt_sno_rai
    )
    return Tendencies1M(dq_lcl_dt, dq_icl_dt, dq_rai_dt, dq_sno_dt)


# ---------------------------------------------------------------------------
# Donor-based linearization + implicit substep
# (reference src/BulkMicrophysicsTendencies.jl:254-465)
# ---------------------------------------------------------------------------

def _linearize(src: SourceTerms1M, q_lcl, q_icl, q_rai, q_sno, q_min):
    """Local linear model dq/dt = M q + e with donor-based coefficients
    ``D = S / max(q_min, q_donor)``
    (reference src/BulkMicrophysicsTendencies.jl:270-378)."""
    zero = torch.zeros_like(q_lcl)

    def donor(S, q):
        return S / torch.clamp(q, min=q_min)

    M11 = M12 = M22 = M31 = M33 = M34 = zero
    M41 = M42 = M43 = M44 = e1 = e2 = e4 = zero

    # vapor <-> cloud condensate: source -> constant e; sink -> linear
    D = donor(src.S_phase_change_vap_lcl, q_lcl)
    is_src = src.S_phase_change_vap_lcl >= 0
    e1 = e1 + torch.where(is_src, src.S_phase_change_vap_lcl, zero)
    M11 = M11 + torch.where(is_src, zero, D)

    D = donor(src.S_phase_change_vap_icl, q_icl)
    is_src = src.S_phase_change_vap_icl >= 0
    e2 = e2 + torch.where(is_src, src.S_phase_change_vap_icl, zero)
    M22 = M22 + torch.where(is_src, zero, D)

    # ice cloud melt -> liquid cloud
    D = donor(src.S_melt_icl_lcl, q_icl)
    M22 = M22 - D
    M12 = M12 + D

    # autoconversion
    D = donor(src.S_acnv_lcl_rai, q_lcl)
    M11 = M11 - D
    M31 = M31 + D
    D = donor(src.S_acnv_icl_sno, q_icl)
    M22 = M22 - D
    M42 = M42 + D

    # accretion
    D = donor(src.S_accr_lcl_rai, q_lcl)
    M11 = M11 - D
    M31 = M31 + D

    D_cold = donor(src.S_accr_lcl_sno_cold, q_lcl)
    D_warm = donor(src.S_accr_lcl_sno_warm, q_lcl)
    M11 = M11 - (D_cold + D_warm)
    M31 = M31 + D_warm
    M41 = M41 + D_cold

    D = donor(src.S_accr_melt_lcl_sno, q_sno)
    M44 = M44 - D
    M34 = M34 + D

    D = donor(src.S_accr_icl_rai, q_icl)
    M22 = M22 - D
    M42 = M42 + D

    D = donor(src.S_accr_icl_sno, q_icl)
    M22 = M22 - D
    M42 = M42 + D

    D = donor(src.S_accr_freeze_icl_rai, q_rai)
    M33 = M33 - D
    M43 = M43 + D

    D = donor(src.S_accr_rai_sno_warm, q_sno)
    M44 = M44 - D
    M34 = M34 + D

    D = donor(src.S_accr_melt_rai_sno, q_sno)
    M44 = M44 - D
    M34 = M34 + D

    D = donor(src.S_accr_rai_sno_cold, q_rai)
    M33 = M33 - D
    M43 = M43 + D

    # rain evaporation: sink (<= 0) -> linear
    D = donor(-src.S_phase_change_vap_rai, q_rai)
    M33 = M33 - D

    # snow dep/subl: source -> e; sink -> linear
    D = donor(src.S_phase_change_vap_sno, q_sno)
    is_src = src.S_phase_change_vap_sno >= 0
    e4 = e4 + torch.where(is_src, src.S_phase_change_vap_sno, zero)
    M44 = M44 + torch.where(is_src, zero, D)

    # snow melt -> rain
    D = donor(src.S_melt_sno_rai, q_sno)
    M44 = M44 - D
    M34 = M34 + D

    return dict(M11=M11, M12=M12, M22=M22, M31=M31, M33=M33, M34=M34,
                M41=M41, M42=M42, M43=M43, M44=M44, e1=e1, e2=e2, e4=e4)


def _linearized_implicit_step(
    mp, tps, rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno, dt_sub,
) -> Tendencies1M:
    """One linearized implicit substep: solve (q* - q0)/dt = M q* + e with
    the 1M sparse structure (two 2x2 blocks)
    (reference src/BulkMicrophysicsTendencies.jl:383-465)."""
    dt = float_dtype(q_tot)
    src = microphysics_source_terms_1m(
        mp, tps, rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno)
    lin = _linearize(src, q_lcl, q_icl, q_rai, q_sno, tps.q_min)

    inv_dt = 1.0 / dt_sub

    # Cap vap->condensate sources jointly so the substep cannot drive q_v
    # below min(q_sat_liq, q_sat_ice); preserves relative rates.
    q_sat_min = torch.minimum(
        TDI.saturation_vapor_specific_content_over_liquid(tps, T, rho),
        TDI.saturation_vapor_specific_content_over_ice(tps, T, rho),
    )
    q_v = q_tot - q_lcl - q_icl - q_rai - q_sno
    e_sum = lin["e1"] + lin["e2"] + lin["e4"]
    alpha = torch.clamp(
        clamp_to_nonneg(q_v - q_sat_min) * inv_dt
        / torch.clamp(e_sum, min=machine_eps(dt)),
        max=1.0,
    )

    a11 = inv_dt - lin["M11"]
    a12 = -lin["M12"]
    a22 = inv_dt - lin["M22"]
    a31 = -lin["M31"]
    a33 = inv_dt - lin["M33"]
    a34 = -lin["M34"]
    a41 = -lin["M41"]
    a42 = -lin["M42"]
    a43 = -lin["M43"]
    a44 = inv_dt - lin["M44"]

    b1 = alpha * lin["e1"] + inv_dt * q_lcl
    b2 = alpha * lin["e2"] + inv_dt * q_icl
    b3 = inv_dt * q_rai
    b4 = alpha * lin["e4"] + inv_dt * q_sno

    # 2x2 cloud block (a21 = 0)
    det12 = a11 * a22
    q_lcl_new = (b1 * a22 - a12 * b2) / det12
    q_icl_new = a11 * b2 / det12

    # reduced 2x2 precip block
    r3 = b3 - a31 * q_lcl_new
    r4 = b4 - a41 * q_lcl_new - a42 * q_icl_new
    det = a33 * a44 - a34 * a43  # positive by construction
    q_rai_new = (r3 * a44 - a34 * r4) / det
    q_sno_new = (a33 * r4 - r3 * a43) / det

    return Tendencies1M(
        (q_lcl_new - q_lcl) * inv_dt,
        (q_icl_new - q_icl) * inv_dt,
        (q_rai_new - q_rai) * inv_dt,
        (q_sno_new - q_sno) * inv_dt,
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def bulk_tendencies_0m(mp: Microphysics0MParams, tps: TPS,
                       T, q_lcl, q_icl, q_vap_sat=None):
    """0-moment fused tendency: total-water removal rate [kg/kg/s]
    (reference src/BulkMicrophysicsTendencies.jl:636-683)."""
    q_lcl = clamp_to_nonneg(q_lcl)
    q_icl = clamp_to_nonneg(q_icl)
    return CM0.remove_precipitation(mp.precip, q_lcl, q_icl, q_vap_sat)


def bulk_tendencies_1m(
    mp: Microphysics1MParams, tps: TPS,
    rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno,
    mode: str = "instantaneous", dt=None, nsub: int = 1, sd=None,
):
    """1-moment fused tendencies.

    ``mode``:
    * ``"instantaneous"`` -> :class:`Tendencies1M`
    * ``"instantaneous_verbose"`` -> ``(Tendencies1M, SourceTerms1M)``
    * ``"linearized_average"`` -> :class:`Tendencies1M` averaged over ``dt``
      via ``nsub`` linearized implicit substeps
      (reference src/BulkMicrophysicsTendencies.jl:547-633).
    """
    if mode == "instantaneous":
        src = microphysics_source_terms_1m(
            mp, tps, rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno, sd)
        return aggregate_tendencies_1m(src)
    if mode == "instantaneous_verbose":
        src = microphysics_source_terms_1m(
            mp, tps, rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno, sd)
        return aggregate_tendencies_1m(src), src
    if mode != "linearized_average":
        raise ValueError(f"unknown tendency mode {mode!r}")

    if dt is None:
        raise ValueError("linearized_average requires dt")
    dt_sub = dt / nsub
    Lv_over_cp = tps.LH_v0 / tps.cp_d
    Ls_over_cp = tps.LH_s0 / tps.cp_d

    T_c = T + torch.zeros_like(q_lcl)
    q_lcl_c, q_icl_c, q_rai_c, q_sno_c = q_lcl, q_icl, q_rai, q_sno
    for _ in range(nsub):
        rates = _linearized_implicit_step(
            mp, tps, rho, T_c, q_tot, q_lcl_c, q_icl_c, q_rai_c, q_sno_c,
            dt_sub)
        q_lcl_c = q_lcl_c + rates.dq_lcl_dt * dt_sub
        q_icl_c = q_icl_c + rates.dq_icl_dt * dt_sub
        q_rai_c = q_rai_c + rates.dq_rai_dt * dt_sub
        q_sno_c = q_sno_c + rates.dq_sno_dt * dt_sub
        T_c = T_c + (
            Lv_over_cp * (rates.dq_lcl_dt + rates.dq_rai_dt)
            + Ls_over_cp * (rates.dq_icl_dt + rates.dq_sno_dt)
        ) * dt_sub
    return Tendencies1M(
        (q_lcl_c - q_lcl) / dt,
        (q_icl_c - q_icl) / dt,
        (q_rai_c - q_rai) / dt,
        (q_sno_c - q_sno) / dt,
    )


# ---------------------------------------------------------------------------
# 2-moment warm rain (Seifert-Beheng 2006)
# (reference src/BulkMicrophysicsTendencies.jl:707-861)
# ---------------------------------------------------------------------------

class Tendencies2M(NamedTuple):
    """Warm + (optional) P3 ice tendencies. Ice fields are zero for the
    warm-only configuration."""

    dq_lcl_dt: torch.Tensor
    dn_lcl_dt: torch.Tensor
    dq_rai_dt: torch.Tensor
    dn_rai_dt: torch.Tensor
    dq_ice_dt: torch.Tensor
    dn_ice_dt: torch.Tensor
    dq_rim_dt: torch.Tensor
    db_rim_dt: torch.Tensor


def warm_rain_tendencies_2m(warm_rain, tps: TPS, T, q_tot, q_lcl, q_rai,
                            q_ice, rho, n_lcl, n_rai):
    """All SB2006 warm-rain processes in one pass
    (reference src/BulkMicrophysicsTendencies.jl:707-782).

    ``n_lcl``/``n_rai`` are specific numbers [1/kg]; the ops/m2 functions
    take number densities ``N = rho n`` [1/m^3]. Returns
    ``(dq_lcl_dt, dq_rai_dt, dn_lcl_dt, dn_rai_dt)``.
    """
    from ..ops import m2 as CM2

    sb = warm_rain.seifert_beheng
    aps = warm_rain.air_properties

    N_lcl = rho * n_lcl
    N_rai = rho * n_rai
    zero = torch.zeros_like(rho)

    # condensation/evaporation of cloud liquid (constant-tau relaxation)
    tau = warm_rain.condevap.tau_relax
    Rv = tps.R_v
    Lv = TDI.latent_heat_vapor(tps, T)
    cp_air = TDI.cp_m(tps, q_tot, q_lcl + q_rai, q_ice)
    qv = TDI.q_vap(q_tot, q_lcl + q_rai, q_ice)
    qv_sat = TDI.saturation_vapor_specific_content_over_liquid(tps, T, rho)
    Gamma_l = CMNonEq.gamma_helper(Lv, cp_air,
                                   CMNonEq.dqcld_dT(qv_sat, Lv, Rv, T))
    timescale = tau * Gamma_l
    dq_lcl_cond = CMNonEq._relaxation_tendency(qv - qv_sat, q_lcl, timescale,
                                               timescale)

    # rain evaporation
    dn_evap, dq_evap = CM2.rain_evaporation(
        sb, aps, tps, q_tot, q_lcl, q_ice, q_rai, zero, rho, N_rai, T)

    # autoconversion + cloud self-collection
    acnv = CM2.autoconversion(sb.acnv, sb.pdf_c, q_lcl, q_rai, rho, N_lcl)
    sc_lcl = CM2.cloud_liquid_self_collection(sb.acnv, sb.pdf_c, q_lcl, rho,
                                              acnv.dN_lcl_dt)

    # accretion
    accr = CM2.accretion(sb, q_lcl, q_rai, rho, N_lcl)

    # rain self-collection + breakup
    sc_rai = CM2.rain_self_collection(sb.pdf_r, sb.self_col, q_rai, rho,
                                      N_rai)
    br_rai = CM2.rain_breakup(sb.pdf_r, sb.brek, q_rai, rho, N_rai, sc_rai)

    # number adjustment from mass limits (Horn 2012)
    numadj_lcl = CM2.number_tendency_from_mass_limits(
        sb.pdf_c.xc_min, sb.pdf_c.xc_max, sb.numadj.tau, q_lcl, n_lcl)
    numadj_rai = CM2.number_tendency_from_mass_limits(
        sb.pdf_r.xr_min, sb.pdf_r.xr_max, sb.numadj.tau, q_rai, n_rai)

    dq_lcl_dt = dq_lcl_cond + acnv.dq_lcl_dt + accr.dq_lcl_dt
    dq_rai_dt = dq_evap + acnv.dq_rai_dt + accr.dq_rai_dt
    dn_lcl_dt = (acnv.dN_lcl_dt + sc_lcl + accr.dN_lcl_dt) / rho + numadj_lcl
    dn_rai_dt = (dn_evap + acnv.dN_rai_dt + sc_rai + br_rai) / rho \
        + numadj_rai
    return dq_lcl_dt, dq_rai_dt, dn_lcl_dt, dn_rai_dt


def bulk_tendencies_2m(mp: Microphysics2MParams, tps: TPS, rho, T, q_tot,
                       q_lcl, n_lcl, q_rai, n_rai, q_ice=None, n_ice=None,
                       q_rim=None, b_rim=None, log_lambda=None,
                       inpc_log_shift=None, p3_aux=None) -> Tendencies2M:
    """2-moment fused tendencies: SB2006 warm rain, plus P3 ice when
    ``mp.ice`` is set (reference src/BulkMicrophysicsTendencies.jl:824-1083).

    ``p3_aux`` optionally passes a step-shared
    :class:`.p3_tendencies.P3StepAux` (sanitized state + ice quadrature
    nodes) so a column step can reuse the same node tables for its
    sedimentation velocities.
    """
    rho = clamp_to_nonneg(rho)
    q_tot = clamp_to_nonneg(q_tot)
    q_lcl = clamp_to_nonneg(q_lcl)
    q_rai = clamp_to_nonneg(q_rai)
    n_lcl = clamp_to_nonneg(n_lcl)
    n_rai = clamp_to_nonneg(n_rai)
    zero = torch.zeros_like(torch.as_tensor(rho) * torch.as_tensor(T))
    q_ice = zero if q_ice is None else clamp_to_nonneg(q_ice)

    dq_lcl_dt, dq_rai_dt, dn_lcl_dt, dn_rai_dt = warm_rain_tendencies_2m(
        mp.warm_rain, tps, T, q_tot, q_lcl, q_rai, q_ice, rho, n_lcl, n_rai)

    if getattr(mp, "ice", None) is None:
        return Tendencies2M(dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt,
                            zero, zero, zero, zero)

    from .p3_tendencies import ice_tendencies_2m_p3

    return ice_tendencies_2m_p3(
        mp, tps, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
        q_ice, n_ice, q_rim, b_rim, log_lambda, inpc_log_shift,
        warm=(dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt),
        aux=p3_aux,
    )


# ---------------------------------------------------------------------------
# Single-entry dispatch (reference src/BulkMicrophysicsTendencies.jl:38-46):
# the parameter container's type selects the scheme
# ---------------------------------------------------------------------------

def bulk_microphysics_tendencies(mp, tps, *args, **kwargs):
    """Scheme-dispatching fused tendency entry point.

    ``mp`` selects the scheme: ``Microphysics0MParams`` -> 0M,
    ``Microphysics1MParams`` -> 1M (kwargs: mode/dt/nsub),
    ``Microphysics2MParams`` -> 2M warm rain (+P3 when ``mp.ice`` set).
    """
    if isinstance(mp, Microphysics0MParams):
        return bulk_tendencies_0m(mp, tps, *args, **kwargs)
    if isinstance(mp, Microphysics1MParams):
        return bulk_tendencies_1m(mp, tps, *args, **kwargs)
    if isinstance(mp, Microphysics2MParams):
        return bulk_tendencies_2m(mp, tps, *args, **kwargs)
    raise TypeError(
        f"no microphysics scheme for parameter type {type(mp).__name__}")
