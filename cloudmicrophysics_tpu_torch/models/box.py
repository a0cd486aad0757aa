"""Alpert-Knopf immersion-freezing box model (L6 driver).

Port of ``cloudmicrophysics_tpu/models/box.py`` (reference ``box/box.jl``):
a cooling box of droplets freezing via ABIFM. Two variants:

* :func:`run_box` — deterministic rate ``dN_ice/dt = J(T) N_liq A``;
* :func:`run_box_stochastic` — the Alpert & Knopf 2016 per-droplet
  binomial-sampling variant, with a per-droplet surface-area vector: each
  droplet freezes with probability ``1 - exp(-A_j J dt)`` per step (frozen
  droplets are removed), one uniform draw per droplet and step.

Both run where their state lives, with no wait on the device per step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import asarray

__all__ = ["BoxState", "run_box", "run_box_stochastic"]


class BoxState(NamedTuple):
    T: torch.Tensor       # temperature [K]
    A_sum: torch.Tensor   # total available surface area [m^2]
    N_liq: torch.Tensor   # droplet number [1/m^3 or count]
    N_ice: torch.Tensor   # ice number


def run_box(ic: BoxState, t_0, t_end, tps: ThermodynamicsParameters,
            aerosol, cooling_rate, A_aero, dt):
    """Deterministic ABIFM freezing in a cooling box
    (reference box/box.jl:11-40). Returns the trajectory, the initial
    condition first (``n_steps + 1`` rows)."""
    n_steps = int(round((t_end - t_0) / dt))
    # lax.scan's stacked outputs with the initial condition prepended, as
    # one preallocated tensor per field
    traj = BoxState(*(torch.empty((n_steps + 1, *v.shape), dtype=v.dtype,
                                  device=v.device) for v in ic))
    for buf, v in zip(traj, ic):
        buf[0] = v
    y = ic
    for i in range(n_steps):
        da = 1 - CMO.a_w_ice(tps, y.T)
        J = CMI.ABIFM_J(aerosol, da)
        rate = torch.where(y.N_liq > 0, J * y.N_liq * A_aero,
                           torch.zeros_like(y.N_liq))
        y = BoxState(
            T=y.T - cooling_rate * dt,
            A_sum=y.A_sum,
            N_liq=y.N_liq - rate * dt,
            N_ice=y.N_ice + rate * dt,
        )
        for buf, v in zip(traj, y):
            buf[i + 1] = v
    return traj


def _stochastic_step(tps, aerosol, cooling_rate, dt, Aj, T, frozen, u):
    """One step of the stochastic box (the JAX package's scan body,
    ``box.py:73-86``) with the uniforms ``u`` given, one per droplet.
    Returns ``(T_new, frozen, n_liq, n_ice, a_sum)``."""
    da = 1 - CMO.a_w_ice(tps, T)
    J = CMI.ABIFM_J(aerosol, da)
    # freezing probability per droplet this step (A&K 2016 eq 10)
    P_frz = 1 - torch.exp(-Aj * J * dt)
    freeze_event = (u < P_frz) & ~frozen
    frozen = frozen | freeze_event
    T_new = T - cooling_rate * dt
    n_liq = torch.sum(~frozen)
    n_ice = torch.sum(frozen)
    a_sum = torch.sum(torch.where(frozen, torch.zeros_like(Aj), Aj))
    return T_new, frozen, n_liq, n_ice, a_sum


def run_box_stochastic(T0, Aj, t_0, t_end, tps: ThermodynamicsParameters,
                       aerosol, cooling_rate, dt, rng_key):
    """Stochastic per-droplet freezing (Alpert & Knopf 2016;
    reference box/box.jl:45-96).

    ``Aj`` is the per-droplet surface-area tensor (its length is the
    droplet count); ``rng_key`` a ``torch.Generator`` on its device (one
    seeded 0 when ``None``). Returns the ``(T, N_liq, N_ice, A_sum)``
    trajectories, ``n_steps`` rows each, the initial condition not among
    them.
    """
    n_steps = int(round((t_end - t_0) / dt))
    if rng_key is None:
        rng_key = torch.Generator(device=Aj.device).manual_seed(0)
    out_T = torch.empty(n_steps, dtype=Aj.dtype, device=Aj.device)
    out_liq = torch.empty(n_steps, dtype=torch.int64, device=Aj.device)
    out_ice = torch.empty_like(out_liq)
    out_a = torch.empty_like(out_T)
    T = asarray(T0, Aj)
    frozen = torch.zeros(Aj.shape, dtype=torch.bool, device=Aj.device)
    for i in range(n_steps):
        u = torch.rand(Aj.shape, generator=rng_key, dtype=Aj.dtype,
                       device=Aj.device)
        T, frozen, out_liq[i], out_ice[i], out_a[i] = _stochastic_step(
            tps, aerosol, cooling_rate, dt, Aj, T, frozen, u)
        out_T[i] = T
    return out_T, out_liq, out_ice, out_a
