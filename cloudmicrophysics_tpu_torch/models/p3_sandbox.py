"""Minimal P3 ice sandbox driver.

Port of ``cloudmicrophysics_tpu/models/p3_sandbox.py`` (reference
``p3_sandbox/p3_sandbox.jl``): a 4-variable ODE ``[N_ice, q_ice, q_rim,
B_rim]`` with ABIFM immersion nucleation as the (only) source,
Euler-stepped. A development scaffold for exercising the P3 state and
threshold machinery.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..ops import p3 as P3
from ..parameters.p3 import ParametersP3
from ..parameters.thermodynamics import ThermodynamicsParameters

PI = math.pi

__all__ = ["P3SandboxState", "run_p3_sandbox"]


class P3SandboxState(NamedTuple):
    N_ice: torch.Tensor
    q_ice: torch.Tensor
    q_rim: torch.Tensor
    B_rim: torch.Tensor


def run_p3_sandbox(ic: P3SandboxState, t_0, t_end, dt,
                   p3: ParametersP3, tps: ThermodynamicsParameters,
                   aerosol, T, p_air, q_vap, q_liq, N_liq, r_liq):
    """Euler-step the sandbox ODE; returns the trajectory (``n_steps`` rows
    per field, the initial condition not among them, as the JAX package's
    scan outputs) and the final P3 state thresholds (D_th, D_gr, D_cr,
    rho_g)."""
    n_steps = int(round((t_end - t_0) / dt))
    q_tot = q_vap + q_liq

    # the JAX package's jnp.asarray(..., float) is the default float dtype,
    # which matches the inputs' under x64 and float32 without it: the
    # inputs' own dtype here
    R_a = tps.R_d * (1 - q_tot) + tps.R_v * (q_tot - q_liq)
    e = q_vap * p_air * tps.R_v / R_a
    da_w = CMO.a_w_eT(tps, e, T) - CMO.a_w_ice(tps, T)
    J_imm = CMI.ABIFM_J(aerosol, da_w)
    dN_dt = J_imm * N_liq * 4 * PI * r_liq**2

    # lax.scan's stacked outputs, one preallocated tensor per field
    traj = P3SandboxState(*(
        torch.empty((n_steps, *v.shape), dtype=v.dtype, device=v.device)
        for v in ic))
    y = ic
    for i in range(n_steps):
        y = P3SandboxState(N_ice=y.N_ice + dt * dN_dt, q_ice=y.q_ice,
                           q_rim=y.q_rim, B_rim=y.B_rim)
        for buf, v in zip(traj, y):
            buf[i] = v

    # thresholds from the final rime state
    q_ice, q_rim, B_rim = traj.q_ice[-1], traj.q_rim[-1], traj.B_rim[-1]
    F_rim = torch.where(q_ice > 0, q_rim / torch.clamp(q_ice, min=1e-30),
                        torch.zeros_like(q_ice))
    rho_rim = torch.where(B_rim > 0, q_rim / torch.clamp(B_rim, min=1e-30),
                          torch.zeros_like(B_rim))
    state = P3.p3_state(p3, q_ice, traj.N_ice[-1], F_rim, rho_rim)
    thresholds = (state.D_th, state.D_gr, state.D_cr, state.rho_g)
    return traj, thresholds
