"""Column model driver (L6): ``(ncol, nlev)`` tensors + sedimentation.

Port of ``cloudmicrophysics_tpu/models/column.py:1-169``. The reference
library is pointwise; the host model applies terminal velocities in an
upwind vertical flux. This module supplies that host-model role:

* the state is a NamedTuple of ``(ncol, nlev)`` tensors;
* all process rates are one elementwise pass (the 1M bulk tendencies);
* sedimentation is a first-order upwind donor-cell flux, a per-column
  shift: level k receives the flux from level k+1 above. Columns are
  independent.

Convention: level index k increases upward (k = 0 is the surface);
hydrometeors fall toward k = 0. The flux through the bottom interface is
the surface precipitation rate diagnostic.

:class:`Column1MStep` is the module a caller drives: it holds the
parameters and the kernel's parameter buffer, and steps the state through
the fused CUDA kernel (or its plain version on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops import m1 as CM1
from ..ops import noneq as CMNonEq
from ..ops import thermo as TDI
from ..ops.states import MicroState, ThermoState
from ..parameters.m1 import Microphysics1MParams
from ..parameters.terminal_velocity import TerminalVelocityParams
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import clamp_to_nonneg
from . import tendencies as BMT

__all__ = ["Column1MStep", "ColumnState", "sedimentation_tendency",
           "step_column_1m", "surface_precip_rate"]


class ColumnState(NamedTuple):
    """Prognostic column state; every field is ``(ncol, nlev)``."""

    rho: torch.Tensor     # air density [kg/m^3] (held fixed)
    T: torch.Tensor       # temperature [K]
    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    q_icl: torch.Tensor
    q_rai: torch.Tensor
    q_sno: torch.Tensor


def sedimentation_tendency(rho, q, w, dz):
    """Upwind donor-cell sedimentation: ``dq/dt = (F_in - F_out)/(rho dz)``
    with ``F_k = rho_k w_k q_k`` falling downward (toward k = 0).

    The incoming flux at level k is the outgoing flux of level k+1; the top
    level has no inflow.
    """
    F = rho * w * q  # downward mass flux [kg/m^2/s]
    F_in = torch.cat([F[..., 1:], torch.zeros_like(F[..., :1])], dim=-1)
    return (F_in - F) / (rho * dz)


def surface_precip_rate(state: ColumnState, mp: Microphysics1MParams,
                        tv: TerminalVelocityParams):
    """Surface rain + snow flux [kg/m^2/s] (positive down)."""
    q_rai0 = state.q_rai[..., 0]
    q_sno0 = state.q_sno[..., 0]
    rho0 = state.rho[..., 0]
    w_rai = CM1.terminal_velocity(
        mp.precip.rain, mp.terminal_velocity.rain, rho0, q_rai0)
    w_sno = CM1.terminal_velocity(
        mp.precip.snow, mp.terminal_velocity.snow, rho0, q_sno0)
    return rho0 * (w_rai * q_rai0 + w_sno * q_sno0)


def step_column_1m(
    state: ColumnState,
    mp: Microphysics1MParams,
    tps: ThermodynamicsParameters,
    tv: TerminalVelocityParams,
    dt,
    dz,
    mode: str = "instantaneous",
    nsub: int = 1,
    sediment_cloud: bool = True,
) -> ColumnState:
    """One explicit Euler step: process rates + sedimentation, in eager
    PyTorch (the plain version of the fused kernel)."""
    # PSD parameters computed ONCE and shared between the process rates and
    # the sedimentation velocities (the clamps mirror
    # microphysics_source_terms_1m so the shared sd is identical)
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

    # terminal velocities for sedimentation (per reference
    # src/parameters/TerminalVelocity.jl:356-366 usage table), sharing the
    # PSD solve with the process rates
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

    # latent heating from phase changes, with T-dependent latent heats and
    # moist cp (ops/thermo mirrors reference
    # src/ThermodynamicsInterface.jl:9-125)
    Lv = TDI.latent_heat_vapor(tps, state.T)
    Ls = TDI.latent_heat_sublim(tps, state.T)
    cp = TDI.cp_m(tps, micro.q_tot, micro.q_lcl + micro.q_rai,
                  micro.q_icl + micro.q_sno)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt)
        + Ls * (rates.dq_icl_dt + rates.dq_sno_dt)
    ) / cp

    # total water loses what falls out (sedimentation of all species)
    q_tot = state.q_tot + dt * (sed_lcl + sed_icl + sed_rai + sed_sno)

    return ColumnState(
        rho=state.rho, T=T_new, q_tot=clamp_to_nonneg(q_tot),
        q_lcl=clamp_to_nonneg(q_lcl), q_icl=clamp_to_nonneg(q_icl),
        q_rai=clamp_to_nonneg(q_rai), q_sno=clamp_to_nonneg(q_sno),
    )


class Column1MStep(nn.Module):
    """One fused 1M column step (instantaneous tendencies, explicit Euler).

    Holds the parameters, ``dt``, ``dz`` and the kernel's float32 parameter
    buffer (built once, on the host in float64; it follows the module
    through ``.to(device)``). ``forward(state, q_tot_affine=None)`` advances
    either a packed ``(7, ncol, nlev)`` tensor (see
    :func:`..kernels.column1m.pack_state`) or a :class:`ColumnState` by one
    step and returns the same kind. On CUDA tensors it launches the fused
    kernel; on CPU tensors it runs the plain version. A thread block steps
    the largest power of two of columns, up to 128, that divides ``ncol``.
    """

    def __init__(self, mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                 tv: TerminalVelocityParams, dt: float, dz: float):
        super().__init__()
        from ..kernels.column1m import kernel_params

        self.mp, self.tps, self.tv = mp, tps, tv
        self.dt, self.dz = float(dt), float(dz)
        self.register_buffer("params", kernel_params(mp, tps, tv),
                             persistent=False)

    def forward(self, state, q_tot_affine=None):
        from ..kernels import column1m as K

        if isinstance(state, ColumnState):
            step, ncol = K.step_column_1m_fused, state.rho.shape[0]
        else:
            step, ncol = K.step_column_1m_fused_packed, state.shape[1]
        block_cols = ncol & -ncol if ncol % 128 else 128
        return step(state, self.mp, self.tps, self.tv, self.dt, self.dz,
                    block_cols=block_cols, q_tot_affine=q_tot_affine,
                    params=self.params)
