"""Kind ``parcel``: the program's ``parcel_step`` on an ensemble of
adiabatic parcels, one member per column of the harness (``(10, members,
1)`` answers), stepped in a closed loop as an ensemble calibration steps
its forward model; the reference is the frozen plain parcel step.

A carry is ``(state, w)``: the members' ten prognostics and their updrafts,
which the step reads from its parameters and the reference from the carry.
The configuration's processes read neither the time nor the previous
step's dS_l/dt (MohlerAF deposition does; MohlerRate would), so the step
is given 0 and zeros for them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import inputs
from ..reference.models import parcel as R
from ..reference.ops import thermo
from ..reference.parameters.thermodynamics import ThermodynamicsParameters

FIELDS = R.ParcelState._fields
# the processes the frozen reference steps
PHYSICS = {"aerosol": "DesertDust", "deposition": "MohlerAF",
           "deposition_growth": "Deposition", "aerosol_act": "None",
           "heterogeneous": "None", "homogeneous": "None",
           "condensation_growth": "None",
           "liq_size_distribution": "Monodisperse",
           "ice_size_distribution": "Monodisperse"}


def initial_S_l(p_air: float, T: float, q_vap: float, q_liq: float,
                q_ice: float) -> float:
    """The saturation ratio over liquid of a parcel at rest (reference
    parcel examples' ``get_initial_condition``), in float64."""
    tps = ThermodynamicsParameters()
    q_tot = q_vap + q_liq + q_ice
    R_a = tps.R_d * (1 - q_tot) + tps.R_v * q_vap
    e_sl = float(thermo.saturation_vapor_pressure_over_liquid(
        tps, torch.tensor(T, dtype=torch.float64)))
    return q_vap * p_air * tps.R_v / R_a / e_sl


class Cell:
    """One parcel ensemble cell: ``config`` gives the members, the physics
    and the initial state, ``workload`` the step (``dt``); ``ncol``
    overrides the members (tests)."""

    groups = {"state_off": ("share", slice(0, len(FIELDS))),
              "column_off": ("column", slice(0, len(FIELDS))),
              "state_gap": ("gap", slice(0, len(FIELDS)))}
    kernels = {}

    def __init__(self, config: dict, workload: dict, device, ncol=None):
        from cloudmicrophysics_tpu_torch.models import parcel as PM
        from cloudmicrophysics_tpu_torch.parameters import aerosol_species

        physics = dict(config["physics"])
        r_nuc = float(physics.pop("r_nuc"))
        if physics != PHYSICS:
            raise ValueError(f"the parcel reference steps {PHYSICS}, not "
                             f"{physics}")
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.ncol = int(ncol or config["members"])
        self.nlev = 1
        self.points = self.ncol
        self.dt = float(workload["step"]["dt"])
        self.config = config
        self.step_fn = PM.parcel_step
        dust = getattr(aerosol_species, physics.pop("aerosol"))()
        self.base = PM.parcel_params(aerosol=dust, r_nuc=r_nuc,
                                     const_dt=self.dt, **physics)
        self.params = self.base
        self.constants = R.constants(self.dt, r_nuc)
        self.dS_prev = torch.zeros(self.ncol, device=self.device,
                                   dtype=self.dtype)

    def initial(self, seed: int):
        """Every member at the configuration's initial state; member 0's
        updraft the published one, the others' drawn log-uniform from
        ``seed``."""
        from cloudmicrophysics_tpu_torch.models.parcel import ParcelState

        init = self.config["initial"]
        values = dict(init, S_l=initial_S_l(init["p_air"], init["T"],
                                            init["q_vap"], init["q_liq"],
                                            init["q_ice"]))
        state = ParcelState(**{
            k: torch.full((self.ncol,), values[k], device=self.device,
                          dtype=self.dtype) for k in FIELDS})
        lo, hi = (math.log10(v) for v in self.config["w_members"])
        draws = torch.rand((self.ncol,), generator=inputs.generator(
            seed, self.device), device=self.device, dtype=torch.float64)
        w = torch.pow(10.0, lo + (hi - lo) * draws)
        w[0] = self.config["w"]
        w = w.to(self.dtype)
        self.params = dataclasses.replace(self.base, w=w)
        return state, w

    def scales(self, initial) -> torch.Tensor:
        """Each field's largest magnitude in the seeded state, or, for a
        field that starts at zero, the configuration's ``scale_of``: another
        field's scale or a number."""
        state = initial[0]
        largest = {k: float(f.abs().amax()) for k, f in zip(FIELDS, state)}
        scale = {k: largest[v] if isinstance(v, str) else float(v)
                 for k, v in self.config["scale_of"].items()}
        return torch.tensor([scale.get(k, largest[k]) for k in FIELDS],
                            dtype=torch.float64)

    def restart(self, initial, start_out):
        """The carry an episode starts from: the seeded state."""
        return initial

    def step(self, carry):
        state, w = carry
        new, _ = self.step_fn(self.params, state, 0.0, self.dS_prev)
        return new, w

    def answers(self, carry, cols) -> torch.Tensor:
        return torch.stack([f[cols] for f in carry[0]])[:, :, None]

    def reference(self, carry, cols, dtype) -> torch.Tensor:
        state, w = carry
        ref = R.step(R.ParcelState(*(f[cols].to(dtype) for f in state)),
                     w[cols].to(dtype), self.constants)
        return torch.stack(list(ref))[:, :, None]

    def finite(self, carry) -> bool:
        return all(bool(torch.isfinite(f).all()) for f in carry[0])
