"""The plain 1M and 2M + P3 column steps, frozen for the benchmark.

A copy of the eager steps of ``cloudmicrophysics_tpu_torch/models/column.py``
(``step_column_1m``, ``step_column_p3``) without what the port adds around
them: no kernel, no column sharding, no chunking. The modules below this one
(``ops``, ``models``, ``parameters``, ``utils``) are copies of the port's, so
this package imports nothing of the port and computes in any floating dtype
its inputs carry (float64 for the comparison that decides ``correct``,
bfloat16 for its control).

Convention: level index k increases upward (k = 0 is the surface);
hydrometeors fall toward k = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models import tendencies as BMT
from .ops import m1 as CM1
from .ops import noneq as CMNonEq
from .ops import thermo as TDI
from .ops.states import MicroState, ThermoState
from .utils.special import clamp_to_nonneg

__all__ = ["ColumnState", "ColumnStateP3", "sedimentation_tendency",
           "step_column_1m", "step_column_p3"]


class ColumnState(NamedTuple):
    """1M prognostic column state; every field is ``(ncol, nlev)``."""

    rho: torch.Tensor     # air density [kg/m^3] (held fixed)
    T: torch.Tensor       # temperature [K]
    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    q_icl: torch.Tensor
    q_rai: torch.Tensor
    q_sno: torch.Tensor


class ColumnStateP3(NamedTuple):
    """2M warm rain + P3 ice prognostic column; fields are ``(ncol, nlev)``."""

    rho: torch.Tensor
    T: torch.Tensor
    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    n_lcl: torch.Tensor
    q_rai: torch.Tensor
    n_rai: torch.Tensor
    q_ice: torch.Tensor
    n_ice: torch.Tensor
    q_rim: torch.Tensor
    b_rim: torch.Tensor


def sedimentation_tendency(rho, q, w, dz):
    """Upwind donor-cell sedimentation: ``dq/dt = (F_in - F_out)/(rho dz)``
    with ``F_k = rho_k w_k q_k`` falling downward (toward k = 0); the top
    level has no inflow."""
    F = rho * w * q
    F_in = torch.cat([F[..., 1:], torch.zeros_like(F[..., :1])], dim=-1)
    return (F_in - F) / (rho * dz)


def step_column_1m(state: ColumnState, mp, tps, tv, dt, dz,
                   mode: str = "instantaneous", nsub: int = 1,
                   sediment_cloud: bool = True) -> ColumnState:
    """One explicit Euler step of the 1M column: process rates (with the
    linearized substep solve in ``"linearized_average"``), sedimentation
    and latent heating."""
    micro = MicroState(
        clamp_to_nonneg(state.q_tot), clamp_to_nonneg(state.q_lcl),
        clamp_to_nonneg(state.q_icl), clamp_to_nonneg(state.q_rai),
        clamp_to_nonneg(state.q_sno))
    thermo = ThermoState(clamp_to_nonneg(state.rho), state.T)
    sd = CM1.size_distr_parameters(mp, micro, thermo)

    rates = BMT.bulk_tendencies_1m(
        mp, tps, state.rho, state.T,
        state.q_tot, state.q_lcl, state.q_icl, state.q_rai, state.q_sno,
        mode=mode, dt=dt, nsub=nsub,
        sd=sd if mode != "linearized_average" else None,
    )

    w_rai = CM1.terminal_velocity(
        mp.precip.rain, mp.terminal_velocity.rain, state.rho, state.q_rai,
        v0=sd.v0_rai, lambda_inv=sd.lambda_inv_rai,
        log_lambda_inv=sd.log_lambda_inv_rai)
    w_sno = CM1.terminal_velocity(
        mp.precip.snow, mp.terminal_velocity.snow, state.rho, state.q_sno,
        v0=sd.v0_sno, lambda_inv=sd.lambda_inv_sno,
        log_lambda_inv=sd.log_lambda_inv_sno)
    sed_rai = sedimentation_tendency(state.rho, state.q_rai, w_rai, dz)
    sed_sno = sedimentation_tendency(state.rho, state.q_sno, w_sno, dz)

    if sediment_cloud:
        w_lcl = CMNonEq.terminal_velocity(
            mp.cloud.liquid, tv.stokes, state.rho, state.q_lcl)
        w_icl = CMNonEq.terminal_velocity(
            mp.cloud.ice, tv.chen2022.small_ice, state.rho, state.q_icl)
        sed_lcl = sedimentation_tendency(state.rho, state.q_lcl, w_lcl, dz)
        sed_icl = sedimentation_tendency(state.rho, state.q_icl, w_icl, dz)
    else:
        sed_lcl = sed_icl = torch.zeros_like(state.q_lcl)

    q_lcl = state.q_lcl + dt * (rates.dq_lcl_dt + sed_lcl)
    q_icl = state.q_icl + dt * (rates.dq_icl_dt + sed_icl)
    q_rai = state.q_rai + dt * (rates.dq_rai_dt + sed_rai)
    q_sno = state.q_sno + dt * (rates.dq_sno_dt + sed_sno)

    Lv = TDI.latent_heat_vapor(tps, state.T)
    Ls = TDI.latent_heat_sublim(tps, state.T)
    cp = TDI.cp_m(tps, micro.q_tot, micro.q_lcl + micro.q_rai,
                  micro.q_icl + micro.q_sno)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt)
        + Ls * (rates.dq_icl_dt + rates.dq_sno_dt)
    ) / cp
    q_tot = state.q_tot + dt * (sed_lcl + sed_icl + sed_rai + sed_sno)

    return ColumnState(
        rho=state.rho, T=T_new, q_tot=clamp_to_nonneg(q_tot),
        q_lcl=clamp_to_nonneg(q_lcl), q_icl=clamp_to_nonneg(q_icl),
        q_rai=clamp_to_nonneg(q_rai), q_sno=clamp_to_nonneg(q_sno),
    )


def _chen_or_sb(mp):
    """Rain fall-speed parameterization: SB2006 (also when unset) or
    Chen2022."""
    from .parameters.terminal_velocity import SB2006VelType

    vel = getattr(mp.warm_rain, "terminal_velocity", None)
    return SB2006VelType() if vel is None else vel


def step_column_p3(state: ColumnStateP3, mp, tps, dt, dz,
                   loglambda_guess=None):
    """One explicit Euler step of the 2M warm rain + P3 ice column: the P3
    shape solve (warm-started from ``loglambda_guess``), the process rates,
    sedimentation of rain and ice, latent heating. Returns ``(new_state,
    loglambda)``."""
    from .models.p3_tendencies import p3_step_aux
    from .ops import m2 as CM2
    from .ops import p3 as P3

    ice = mp.ice
    sb = mp.warm_rain.seifert_beheng
    rho = state.rho

    pstate = P3.state_from_prognostic(
        ice.scheme, state.q_ice * rho, state.n_ice * rho, state.q_rim * rho,
        state.b_rim * rho)
    with torch.no_grad():
        loglam = P3.get_distribution_loglambda(pstate, loglambda_guess)

    aux = p3_step_aux(mp, rho, state.q_ice, state.n_ice, state.q_rim,
                      state.b_rim, loglam)
    rates = BMT.bulk_tendencies_2m(
        mp, tps, rho, state.T, state.q_tot, state.q_lcl, state.n_lcl,
        state.q_rai, state.n_rai, state.q_ice, state.n_ice,
        state.q_rim, state.b_rim, loglam, p3_aux=aux)

    vt_n_rai, vt_m_rai = CM2.rain_terminal_velocity(
        sb, _chen_or_sb(mp), state.q_rai, rho, state.n_rai * rho)
    sed_q_rai = sedimentation_tendency(rho, state.q_rai, vt_m_rai, dz)
    sed_n_rai = sedimentation_tendency(rho, state.n_rai, vt_n_rai, dz)

    vt_n_ice = P3.ice_terminal_velocity_number_weighted(
        ice.terminal_velocity, rho, aux.state, aux.loglam, nodes=aux.nodes)
    vt_m_ice = P3.ice_terminal_velocity_mass_weighted(
        ice.terminal_velocity, rho, aux.state, aux.loglam, nodes=aux.nodes)
    sed_q_ice = sedimentation_tendency(rho, state.q_ice, vt_m_ice, dz)
    sed_n_ice = sedimentation_tendency(rho, state.n_ice, vt_n_ice, dz)
    sed_q_rim = sedimentation_tendency(rho, state.q_rim, vt_m_ice, dz)
    sed_b_rim = sedimentation_tendency(rho, state.b_rim, vt_m_ice, dz)

    Lv = TDI.latent_heat_vapor(tps, state.T)
    Lf = TDI.latent_heat_fusion(tps, state.T)
    cp = TDI.cp_m(tps, state.q_tot, state.q_lcl + state.q_rai, state.q_ice)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt + rates.dq_ice_dt)
        + Lf * rates.dq_ice_dt) / cp

    q_ice = clamp_to_nonneg(state.q_ice + dt * (rates.dq_ice_dt + sed_q_ice))
    q_rim = clamp_to_nonneg(state.q_rim + dt * (rates.dq_rim_dt + sed_q_rim))
    new = ColumnStateP3(
        rho=rho, T=T_new,
        q_tot=clamp_to_nonneg(state.q_tot + dt * (sed_q_rai + sed_q_ice)),
        q_lcl=clamp_to_nonneg(state.q_lcl + dt * rates.dq_lcl_dt),
        n_lcl=clamp_to_nonneg(state.n_lcl + dt * rates.dn_lcl_dt),
        q_rai=clamp_to_nonneg(state.q_rai + dt * (rates.dq_rai_dt
                                                  + sed_q_rai)),
        n_rai=clamp_to_nonneg(state.n_rai + dt * (rates.dn_rai_dt
                                                  + sed_n_rai)),
        q_ice=q_ice,
        n_ice=clamp_to_nonneg(state.n_ice + dt * (rates.dn_ice_dt
                                                  + sed_n_ice)),
        q_rim=torch.minimum(q_rim, q_ice),
        b_rim=clamp_to_nonneg(state.b_rim + dt * (rates.db_rim_dt
                                                  + sed_b_rim)),
    )
    return new, loglam
