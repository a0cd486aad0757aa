"""Kind ``column_1m``: the program's ``Column1MStep`` on the packed
``(7, ncol, nlev)`` 1M state, stepped in a closed loop as a host model's
time loop steps it; the reference is the frozen plain 1M step."""

from __future__ import annotations

import torch

from .. import inputs
from .. import reference as R

FIELDS = R.ColumnState._fields


class Cell:
    """One 1M column cell: ``config`` gives the grid, ``workload`` the
    step (``mode``, ``nsub``, ``dt``); ``ncol`` overrides the grid's
    columns (tests)."""

    groups = {"state_off": ("share", slice(0, len(FIELDS))),
              "column_off": ("column", slice(0, len(FIELDS))),
              "state_gap": ("gap", slice(0, len(FIELDS)))}
    kernels = {"k1": ("column1m_step_kernel",)}

    def __init__(self, config: dict, workload: dict, device, ncol=None):
        from cloudmicrophysics_tpu_torch.models.column import Column1MStep
        from cloudmicrophysics_tpu_torch.parameters import (
            ThermodynamicsParameters,
            microphysics_1m_params,
            terminal_velocity_params,
        )

        step = workload["step"]
        self.device = torch.device(device)
        self.ncol = int(ncol or config["ncol"])
        self.nlev = int(config["nlev"])
        self.points = self.ncol * self.nlev
        self.dt, self.dz = float(step["dt"]), float(config["dz"])
        self.mode, self.nsub = step["mode"], int(step["nsub"])
        self.module = Column1MStep(
            microphysics_1m_params(), ThermodynamicsParameters(),
            terminal_velocity_params(), self.dt, self.dz, device=self.device,
            mode=self.mode, nsub=self.nsub)
        self.params = R.params_1m()
        self.recipe = config["state"]

    def initial(self, seed: int) -> torch.Tensor:
        return inputs.make_state(self.recipe, FIELDS, self.ncol, self.nlev,
                                 seed, self.device)

    def scales(self, initial: torch.Tensor) -> torch.Tensor:
        """Each field's largest magnitude in the seeded state."""
        return initial.abs().amax(dim=(1, 2))

    def restart(self, initial: torch.Tensor, start_out) -> torch.Tensor:
        """The carry an episode starts from: the seeded state."""
        return initial

    def step(self, packed: torch.Tensor) -> torch.Tensor:
        return self.module(packed)

    def answers(self, packed: torch.Tensor, cols) -> torch.Tensor:
        return packed[:, cols]

    def reference(self, packed: torch.Tensor, cols, dtype) -> torch.Tensor:
        state = R.ColumnState(*packed[:, cols].to(dtype).unbind(0))
        return torch.stack(list(R.step_column_1m(
            state, *self.params, self.dt, self.dz, mode=self.mode,
            nsub=self.nsub)))

    def finite(self, packed: torch.Tensor) -> bool:
        return bool(torch.isfinite(packed).all())
