"""Kind ``column_p3``: the program's ``ColumnP3Step`` on the eleven 2M +
P3 fields, stepped in a closed loop with each step's ``loglambda`` passed
on as the next step's guess (the first step starts cold); the reference is
the frozen plain 2M + P3 step."""

from __future__ import annotations

import torch

from .. import inputs
from .. import reference as R

FIELDS = R.ColumnStateP3._fields


class Cell:
    """One 2M + P3 column cell: ``config`` gives the grid, ``workload`` the
    step (``dt``, ``quadrature_order``); ``ncol`` overrides the grid's
    columns (tests). A carry is ``(state, loglambda or None)``."""

    # log lambda is compared cell by cell, against a tolerance of its own
    # (ln of 1/m, ~5-12 here): its control, the shape solve in bfloat16,
    # gives no finite log lambda to measure a gap by
    groups = {"state_off": ("share", slice(0, len(FIELDS))),
              "column_off": ("column", slice(0, len(FIELDS))),
              "state_gap": ("gap", slice(0, len(FIELDS))),
              "loglambda_off": ("off", slice(len(FIELDS), len(FIELDS) + 1))}
    kernels = {"k5": ("column_p3_solve_kernel", "column_p3_nodes_kernel",
                      "column_p3_epilogue_kernel")}

    def __init__(self, config: dict, workload: dict, device, ncol=None):
        from cloudmicrophysics_tpu_torch.models.column import ColumnP3Step
        from cloudmicrophysics_tpu_torch.parameters import (
            ThermodynamicsParameters,
            microphysics_2m_params,
        )

        step = workload["step"]
        order = int(step["quadrature_order"])
        self.device = torch.device(device)
        self.ncol = int(ncol or config["ncol"])
        self.nlev = int(config["nlev"])
        self.points = self.ncol * self.nlev
        self.dt, self.dz = float(step["dt"]), float(config["dz"])
        self.module = ColumnP3Step(
            microphysics_2m_params(with_ice=True, quadrature_order=order),
            ThermodynamicsParameters(), self.dt, self.dz, device=self.device)
        self.params = R.params_p3(order)
        self.recipe = config["state"]

    def initial(self, seed: int):
        from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

        fields = inputs.make_state(self.recipe, FIELDS, self.ncol, self.nlev,
                                   seed, self.device)
        return ColumnStateP3(*fields.unbind(0)), None

    def scales(self, initial) -> torch.Tensor:
        """Each field's largest magnitude in the seeded state; 1 for log
        lambda, which is compared against a tolerance of its own."""
        state = initial[0]
        return torch.stack([f.abs().amax() for f in state]
                           + [torch.ones((), device=state.rho.device,
                                         dtype=state.rho.dtype)])

    def restart(self, initial, start_out):
        """The carry an episode starts from: the seeded state, warm-started
        from the log lambda the start step found for it."""
        return initial[0], start_out[1]

    def step(self, carry):
        state, guess = carry
        return self.module(state, guess)

    def answers(self, carry, cols) -> torch.Tensor:
        state, loglam = carry
        return torch.stack([f[cols] for f in state] + [loglam[cols]])

    def reference(self, carry, cols, dtype) -> torch.Tensor:
        state, guess = carry
        ref_state = R.ColumnStateP3(*(f[cols].to(dtype) for f in state))
        ref_guess = None if guess is None else guess[cols].to(dtype)
        new, loglam = R.step_column_p3(ref_state, *self.params, self.dt,
                                       self.dz, ref_guess)
        return torch.stack(list(new) + [loglam])

    def finite(self, carry) -> bool:
        """Whether every field of the state is finite (log lambda is not
        finite where a cell holds no ice)."""
        return all(bool(torch.isfinite(t).all()) for t in carry[0])
