"""A host model's 2M + P3 microphysics step through the point-wise fused
tendencies, frozen for the benchmark.

What ClimaAtmos does with CloudMicrophysics' ``bulk_microphysics_tendencies``
on every grid point of a step, advection and sedimentation left to its own
dycore: the P3 shape solve, warm-started from the last step's log lambda
(``ops/p3.py:get_distribution_loglambda``); the fused tendencies with that
log lambda and a per-point INP log shift (``models/tendencies.py:
bulk_tendencies_2m``, frozen copies of the program's); and the host's
explicit Euler update of the eleven prognostic fields (:func:`host_update`).

The state is flat (:class:`HostState`): the eleven ``(ncol, nlev)`` fields
of a 2M + P3 column state, the INP log shift, and the rates of the step
that made the state (zero in a seeded state). Plain ``torch``: it imports
nothing of the program, and computes in the floating dtype its inputs
carry (the cell's check: float32; it has no matrix product, so TF32,
which PyTorch applies to those alone, never enters).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .column import ColumnStateP3
from .models import tendencies as BMT
from .ops import p3 as P3
from .ops import thermo as TDI
from .utils.special import clamp_to_nonneg

__all__ = ["HostState", "PROGNOSTIC", "RATES", "host_step", "host_update",
           "shape_solve", "step"]

PROGNOSTIC = ColumnStateP3._fields
RATES = BMT.Tendencies2M._fields


class HostState(NamedTuple):
    """The eleven prognostic fields, the INP log shift and the last step's
    rates, each ``(ncol, nlev)``."""

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
    inpc_log_shift: torch.Tensor
    dq_lcl_dt: torch.Tensor
    dn_lcl_dt: torch.Tensor
    dq_rai_dt: torch.Tensor
    dn_rai_dt: torch.Tensor
    dq_ice_dt: torch.Tensor
    dn_ice_dt: torch.Tensor
    dq_rim_dt: torch.Tensor
    db_rim_dt: torch.Tensor


def shape_solve(state: HostState, guess, mp):
    """The P3 shape solve's log lambda on the raw state, warm-started from
    ``guess`` (None: cold), as the column step runs it."""
    rho = state.rho
    pstate = P3.state_from_prognostic(
        mp.ice.scheme, state.q_ice * rho, state.n_ice * rho,
        state.q_rim * rho, state.b_rim * rho)
    with torch.no_grad():
        return P3.get_distribution_loglambda(pstate, guess)


def host_update(state: HostState, rates, tps, dt) -> HostState:
    """One explicit Euler step of the eleven fields by ``rates`` (a
    ``Tendencies2M``), without sedimentation: latent heating of the
    unclamped state as the column step has it, each content and number
    clamped at 0, ``q_rim <= q_ice``, ``q_tot`` and ``rho`` kept (no
    precipitation leaves a point without sedimentation). The new state
    carries ``rates``."""
    Lv = TDI.latent_heat_vapor(tps, state.T)
    Lf = TDI.latent_heat_fusion(tps, state.T)
    cp = TDI.cp_m(tps, state.q_tot, state.q_lcl + state.q_rai, state.q_ice)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt + rates.dq_ice_dt)
        + Lf * rates.dq_ice_dt) / cp
    q_ice = clamp_to_nonneg(state.q_ice + dt * rates.dq_ice_dt)
    q_rim = clamp_to_nonneg(state.q_rim + dt * rates.dq_rim_dt)
    return HostState(
        rho=state.rho, T=T_new, q_tot=state.q_tot,
        q_lcl=clamp_to_nonneg(state.q_lcl + dt * rates.dq_lcl_dt),
        n_lcl=clamp_to_nonneg(state.n_lcl + dt * rates.dn_lcl_dt),
        q_rai=clamp_to_nonneg(state.q_rai + dt * rates.dq_rai_dt),
        n_rai=clamp_to_nonneg(state.n_rai + dt * rates.dn_rai_dt),
        q_ice=q_ice,
        n_ice=clamp_to_nonneg(state.n_ice + dt * rates.dn_ice_dt),
        q_rim=torch.minimum(q_rim, q_ice),
        b_rim=clamp_to_nonneg(state.b_rim + dt * rates.db_rim_dt),
        inpc_log_shift=state.inpc_log_shift, **rates._asdict())


def host_step(tendencies, solve, state: HostState, guess, mp, tps, dt):
    """One host step with the tendency entry ``tendencies`` (the frozen
    ``bulk_microphysics_tendencies``, or the program's) and the shape
    solve ``solve(state, guess)``: ``(new_state, loglambda)``."""
    loglam = solve(state, guess)
    rates = tendencies(mp, tps, *state[:len(PROGNOSTIC)], loglam,
                       state.inpc_log_shift)
    return host_update(state, rates, tps, dt), loglam


def step(state: HostState, guess, mp, tps, dt):
    """The frozen host step."""
    return host_step(BMT.bulk_microphysics_tendencies,
                     lambda s, g: shape_solve(s, g, mp), state, guess, mp,
                     tps, dt)
