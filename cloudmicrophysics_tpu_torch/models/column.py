"""Column model driver (L6): ``(ncol, nlev)`` tensors + sedimentation.

Port of ``cloudmicrophysics_tpu/models/column.py``. The reference
library is pointwise; the host model applies terminal velocities in an
upwind vertical flux. This module supplies that host-model role:

* the state is a NamedTuple of ``(ncol, nlev)`` tensors;
* all process rates are one elementwise pass (the 1M bulk tendencies, the
  2M SB2006 warm-rain tendencies, or the 2M + P3 ice tendencies);
* sedimentation is a first-order upwind donor-cell flux, a per-column
  shift: level k receives the flux from level k+1 above. Columns are
  independent.

Convention: level index k increases upward (k = 0 is the surface);
hydrometeors fall toward k = 0. The flux through the bottom interface is
the surface precipitation rate diagnostic.

:class:`Column1MStep`, :class:`Column2MStep` and :class:`ColumnP3Step` are
the modules a caller drives: each holds the parameters and its kernel's
parameter buffer, and steps the state through its fused CUDA kernel (or
the plain version on the CPU).
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

__all__ = ["Column1MStep", "Column2MStep", "ColumnP3Step", "ColumnState",
           "ColumnState2M", "ColumnStateP3", "sedimentation_tendency",
           "step_column_1m", "step_column_2m", "step_column_p3",
           "surface_precip_rate"]


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
    block (computed on the host in float64 and kept there: the kernel's
    library is built with the block's values compiled in, so it stays on
    the CPU whatever ``device`` and ``.to()`` say). ``device`` is where the
    module steps:
    the GPU unless ``device="cpu"`` is asked for; without a card the
    default raises PyTorch's own error, as the other step modules do.
    ``forward(state, q_tot_affine=None)`` advances either a packed
    ``(7, ncol, nlev)`` tensor (see :func:`..kernels.column1m.pack_state`)
    or a :class:`ColumnState` by one step and returns the same kind. On
    CUDA tensors it launches the fused kernel; on CPU tensors it runs the
    plain version. A thread block steps the largest power of two of
    columns, up to :data:`..kernels.column1m.BLOCK_COLS`, that divides
    ``ncol``.
    """

    def __init__(self, mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                 tv: TerminalVelocityParams, dt: float, dz: float,
                 device: torch.device | str = "cuda"):
        super().__init__()
        from ..kernels.column1m import kernel_params

        if torch.device(device).type == "cuda":
            torch.cuda.get_device_properties(device)   # raises without a card
        self.mp, self.tps, self.tv = mp, tps, tv
        self.dt, self.dz = float(dt), float(dz)
        self.params = kernel_params(mp, tps, tv)

    def forward(self, state, q_tot_affine=None):
        from ..kernels import column1m as K

        if isinstance(state, ColumnState):
            step, ncol = K.step_column_1m_fused, state.rho.shape[0]
        else:
            step, ncol = K.step_column_1m_fused_packed, state.shape[1]
        return step(state, self.mp, self.tps, self.tv, self.dt, self.dz,
                    block_cols=_block_cols(ncol, K.BLOCK_COLS),
                    q_tot_affine=q_tot_affine, params=self.params)


def _block_cols(ncol: int, most: int = 128) -> int:
    """Columns a thread block steps: ``most`` (a power of two), or the
    largest power of two that divides ``ncol`` when ``most`` does not."""
    return ncol & -ncol if ncol % most else most


class ColumnState2M(NamedTuple):
    """2-moment prognostic column; every field is ``(ncol, nlev)``."""

    rho: torch.Tensor
    T: torch.Tensor
    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    n_lcl: torch.Tensor   # specific droplet number [1/kg]
    q_rai: torch.Tensor
    n_rai: torch.Tensor


def step_column_2m(state: ColumnState2M, mp, tps: ThermodynamicsParameters,
                   dt, dz, impl: str = "eager",
                   block_cols: int = 128) -> ColumnState2M:
    """One explicit Euler step of the SB2006 warm-rain column: process rates
    + number- and mass-weighted rain sedimentation (the 2M analog of
    :func:`step_column_1m`; velocities per reference
    src/Microphysics2M.jl:685-739, applied in the upwind flux).

    ``impl`` selects the form (identical math):

    * ``"eager"`` (default) — eager PyTorch on any device, the JAX
      package's ``"xla"``;
    * ``"fused"`` — the packed-state fused kernel
      (:func:`..kernels.column2m.step_column_2m_fused_packed`), the JAX
      package's ``"pallas"``: one CUDA launch per step on CUDA tensors, the
      plain version on CPU tensors. ``block_cols`` is halved until it
      divides ``ncol``.
    """
    from ..ops import m2 as CM2

    if impl == "fused":
        from ..kernels.column2m import (
            pack_state_2m,
            step_column_2m_fused_packed,
            unpack_state_2m,
        )

        ncol = state.rho.shape[0]
        bc = max(block_cols, 1)
        while ncol % bc:
            bc //= 2
        return unpack_state_2m(step_column_2m_fused_packed(
            pack_state_2m(state), mp, tps, dt, dz, block_cols=bc))
    if impl != "eager":
        raise ValueError(f"unknown impl {impl!r} (expected 'eager'|'fused')")

    sb = mp.warm_rain.seifert_beheng
    rates = BMT.bulk_tendencies_2m(
        mp, tps, state.rho, state.T, state.q_tot, state.q_lcl, state.n_lcl,
        state.q_rai, state.n_rai)

    N_rai = state.n_rai * state.rho
    vt_n, vt_m = CM2.rain_terminal_velocity(sb, _chen_or_sb(mp),
                                            state.q_rai, state.rho, N_rai)
    sed_q_rai = sedimentation_tendency(state.rho, state.q_rai, vt_m, dz)
    sed_n_rai = sedimentation_tendency(state.rho, state.n_rai, vt_n, dz)

    Lv = TDI.latent_heat_vapor(tps, state.T)
    cp = TDI.cp_m(tps, state.q_tot, state.q_lcl + state.q_rai,
                  torch.zeros_like(state.q_lcl))
    T_new = state.T + dt * Lv / cp * (rates.dq_lcl_dt + rates.dq_rai_dt)
    return ColumnState2M(
        rho=state.rho, T=T_new,
        q_tot=clamp_to_nonneg(state.q_tot + dt * sed_q_rai),
        q_lcl=clamp_to_nonneg(state.q_lcl + dt * rates.dq_lcl_dt),
        n_lcl=clamp_to_nonneg(state.n_lcl + dt * rates.dn_lcl_dt),
        q_rai=clamp_to_nonneg(state.q_rai + dt * (rates.dq_rai_dt
                                                  + sed_q_rai)),
        n_rai=clamp_to_nonneg(state.n_rai + dt * (rates.dn_rai_dt
                                                  + sed_n_rai)),
    )


def _chen_or_sb(mp):
    """Rain fall-speed parameterization of the 2M column, from
    ``mp.warm_rain.terminal_velocity``: SB2006 Rogers-type (also when
    unset) or Chen2022, as ``microphysics_2m_params(rain_velocity=...)``
    selects it."""
    from ..parameters.terminal_velocity import SB2006VelType

    vel = getattr(mp.warm_rain, "terminal_velocity", None)
    return SB2006VelType() if vel is None else vel


class Column2MStep(nn.Module):
    """One fused 2M warm-rain column step (SB2006, explicit Euler).

    Holds the parameters, ``dt``, ``dz`` and the kernel's float32 parameter
    block (computed on the host in float64 and kept there: the kernel's
    library is built with the block's values and the variant compiled in,
    so it stays on the CPU whatever ``device`` and ``.to()`` say).
    ``device`` is where the module steps: the GPU unless ``device="cpu"``
    is asked for; without a card the default raises PyTorch's own error, as
    the other step modules do. ``forward(state, q_tot_affine=None)``
    advances either a packed ``(7, ncol, nlev)`` tensor (see
    :func:`..kernels.column2m.pack_state_2m`) or a :class:`ColumnState2M` by
    one step and returns the same kind; ``q_tot_affine`` applies to the
    packed state only, as in the JAX package. On CUDA tensors it launches
    the fused kernel; on CPU tensors it runs the plain version. A thread
    block steps the largest power of two of columns, up to
    :data:`..kernels.column2m.BLOCK_COLS`, that divides ``ncol``.
    """

    def __init__(self, mp, tps: ThermodynamicsParameters, dt: float,
                 dz: float, device: torch.device | str = "cuda"):
        super().__init__()
        from ..kernels.column2m import kernel_params_2m

        if torch.device(device).type == "cuda":
            torch.cuda.get_device_properties(device)   # raises without a card
        self.mp, self.tps = mp, tps
        self.dt, self.dz = float(dt), float(dz)
        self.params = kernel_params_2m(mp, tps)

    def forward(self, state, q_tot_affine=None):
        from ..kernels import column2m as K

        if isinstance(state, ColumnState2M):
            if q_tot_affine is not None:
                raise ValueError("q_tot_affine needs the packed state")
            return K.step_column_2m_fused(
                state, self.mp, self.tps, self.dt, self.dz,
                block_cols=_block_cols(state.rho.shape[0], K.BLOCK_COLS),
                params=self.params)
        return K.step_column_2m_fused_packed(
            state, self.mp, self.tps, self.dt, self.dz,
            block_cols=_block_cols(state.shape[1], K.BLOCK_COLS),
            q_tot_affine=q_tot_affine, params=self.params)


class ColumnStateP3(NamedTuple):
    """2M warm rain + P3 ice prognostic column; fields are ``(ncol, nlev)``.

    SB2006 cloud/rain mass and number plus the four P3 ice variables (ice
    mass, ice number, rime mass, rime volume), all specific (per kg of air)
    (reference ``src/BulkMicrophysicsTendencies.jl:898-930``).
    """

    rho: torch.Tensor
    T: torch.Tensor
    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    n_lcl: torch.Tensor
    q_rai: torch.Tensor
    n_rai: torch.Tensor
    q_ice: torch.Tensor   # total ice specific content [kg/kg]
    n_ice: torch.Tensor   # ice specific number [1/kg]
    q_rim: torch.Tensor   # rime mass [kg/kg]
    b_rim: torch.Tensor   # rime volume [m^3/kg]


def step_column_p3(state: ColumnStateP3, mp, tps: ThermodynamicsParameters,
                   dt, dz, loglambda_guess=None, col_chunks: int = None,
                   impl: str = "eager"):
    """One explicit Euler step of the full 2M warm rain + P3 ice column.

    Per step: (1) solve the P3 PSD slope ``log lambda`` per cell
    (fixed-iteration Brent, warm-startable from the previous step, the
    substepping semantics of reference ``src/P3_size_distribution.jl:284``);
    (2) the 2M+P3 process rates; (3) upwind sedimentation with number- and
    mass-weighted fall speeds for rain (SB2006 or Chen 2022) and ice (P3
    quadrature, Chen 2022 + aspect ratio). Returns ``(new_state,
    loglambda)`` so the caller can warm-start the next step's shape solve.

    ``col_chunks``: evaluate the eager step over that many equal chunks of
    columns, one after the other (identical math; bounds the memory of the
    node and pair-space tensors). It must divide ``ncol``.

    ``impl`` selects the form (identical math): ``"eager"`` (default),
    eager PyTorch on any device, the JAX package's XLA path; ``"fused"``,
    the fused kernel (:func:`..kernels.column_p3.step_column_p3_fused`),
    the JAX package's Pallas kernel: three CUDA launches per step on CUDA
    tensors, the plain version on CPU tensors (with the ``block_cols``
    :class:`ColumnP3Step` gives it).
    """
    ncol = state.rho.shape[0]
    if col_chunks and ncol % col_chunks:
        raise ValueError(f"col_chunks={col_chunks} does not divide "
                         f"ncol={ncol}")
    if impl == "fused":
        from ..kernels.column_p3 import step_column_p3_fused

        return step_column_p3_fused(state, mp, tps, dt, dz, loglambda_guess,
                                    block_cols=_block_cols(ncol))
    if impl != "eager":
        raise ValueError(f"unknown impl {impl!r} (expected 'eager'|'fused')")
    if col_chunks and col_chunks > 1:
        size = ncol // col_chunks
        parts = []
        for i in range(col_chunks):
            rows = slice(i * size, (i + 1) * size)
            guess = (None if loglambda_guess is None
                     else loglambda_guess[rows])
            parts.append(step_column_p3(
                ColumnStateP3(*(t[rows] for t in state)), mp, tps, dt, dz,
                guess))
        new = ColumnStateP3(*(torch.cat(f, dim=0)
                              for f in zip(*(p[0] for p in parts))))
        return new, torch.cat([p[1] for p in parts], dim=0)

    from ..ops import m2 as CM2
    from ..ops import p3 as P3
    from .p3_tendencies import p3_step_aux

    ice = mp.ice
    sb = mp.warm_rain.seifert_beheng
    rho = state.rho

    L_ice = state.q_ice * rho
    N_ice = state.n_ice * rho
    L_rim = state.q_rim * rho
    B_rim = state.b_rim * rho
    pstate = P3.state_from_prognostic(ice.scheme, L_ice, N_ice, L_rim, B_rim)
    with torch.no_grad():
        loglam = P3.get_distribution_loglambda(pstate, loglambda_guess)

    # ONE sanitized state + ice node table for the whole step: the tendency
    # assembly and the sedimentation velocities contract the same
    # bounds/velocity/PSD tables. Cells without real ice get placeholder
    # velocities, but their fluxes are exactly zero (rho w q with q = 0).
    aux = p3_step_aux(mp, rho, state.q_ice, state.n_ice, state.q_rim,
                      state.b_rim, loglam)

    rates = BMT.bulk_tendencies_2m(
        mp, tps, rho, state.T, state.q_tot, state.q_lcl, state.n_lcl,
        state.q_rai, state.n_rai, state.q_ice, state.n_ice,
        state.q_rim, state.b_rim, loglam, p3_aux=aux)

    # rain sedimentation (SB2006 or Chen 2022 number/mass-weighted speeds)
    vt_n_rai, vt_m_rai = CM2.rain_terminal_velocity(
        sb, _chen_or_sb(mp), state.q_rai, rho, state.n_rai * rho)
    sed_q_rai = sedimentation_tendency(rho, state.q_rai, vt_m_rai, dz)
    sed_n_rai = sedimentation_tendency(rho, state.n_rai, vt_n_rai, dz)

    # ice sedimentation: P3 bulk fall speeds; rime advects with the bulk
    # ice mass flux (single category: all ice falls together)
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
        # rime invariant: q_rim <= q_ice
        q_rim=torch.minimum(q_rim, q_ice),
        b_rim=clamp_to_nonneg(state.b_rim + dt * (rates.db_rim_dt
                                                  + sed_b_rim)),
    )
    return new, loglam


class ColumnP3Step(nn.Module):
    """One fused 2M warm-rain + P3 ice column step (explicit Euler).

    Holds the parameters, ``dt``, ``dz`` and the kernel's float32 parameter
    buffer (computed on the host in float64, stored on ``device``: the GPU
    unless ``device="cpu"`` is asked for; it follows the module through
    ``.to(device)``). ``forward(state, loglambda_guess=None)`` advances a
    :class:`ColumnStateP3` by one step and returns ``(state, loglambda)``;
    pass the returned ``loglambda`` as the next step's guess to warm-start
    the shape solve. On CUDA tensors it launches the step's three kernels
    (:func:`..kernels.column_p3.step_column_p3_fused`); on CPU tensors it
    runs the plain version. ``block_cols`` is the largest power of two of
    columns, up to 128, that divides ``ncol``.
    """

    def __init__(self, mp, tps: ThermodynamicsParameters, dt: float,
                 dz: float, device: torch.device | str = "cuda"):
        super().__init__()
        from ..kernels.column_p3 import kernel_params_p3

        self.mp, self.tps = mp, tps
        self.dt, self.dz = float(dt), float(dz)
        self.register_buffer("params", kernel_params_p3(mp, tps,
                                                        device=device),
                             persistent=False)

    def forward(self, state: ColumnStateP3, loglambda_guess=None):
        from ..kernels.column_p3 import step_column_p3_fused

        return step_column_p3_fused(
            state, self.mp, self.tps, self.dt, self.dz, loglambda_guess,
            block_cols=_block_cols(state.rho.shape[0]), params=self.params)
