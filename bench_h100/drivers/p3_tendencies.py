"""Kind ``p3_tendencies``: a host model's 2M + P3 microphysics step through
the program's public point-wise tendencies, on every grid point, stepped in
a closed loop (``reference/tendencies_p3.py:host_step``): the program's
shape solve ``loglambda_p3_fused`` warm-started from the last step's log
lambda (cold at the first step), its ``bulk_microphysics_tendencies`` with
that log lambda and a per-point INP log shift, and the host's Euler update
of the eleven fields. The reference is the same host step on the frozen
shape solve and tendencies. The check compares the step's eight rates and
its log lambda.

The state is drawn from the seed by :func:`make_state`, not from a
simulation."""

from __future__ import annotations

import math

import torch

from .. import check
from ..inputs import generator
from ..reference import params_p3
from ..reference import tendencies_p3 as R
from ..reference.ops import thermo
from ..reference.parameters.thermodynamics import ThermodynamicsParameters

NRATES = len(R.RATES)


def make_state(config: dict, ncol: int, seed: int, device,
               dtype=torch.float32) -> R.HostState:
    """The host state of ``config`` drawn from ``seed`` by its ``state``
    recipe, the rates zero (a broadcast zero, never written). Level k of
    ``config["nlev"]`` runs from the lowest (k = 0) to the highest:

    * ``rho`` falls log-linearly and ``T`` linearly between their two
      values;
    * a share ``cloudy_columns`` of the columns is cloudy; a cloudy column
      holds liquid (``q_lcl``, ``n_lcl``) where ``T > liquid_above_K``,
      P3 ice (``q_ice``, ``n_ice``, ``q_rim`` a ``rime_fraction`` of
      ``q_ice``, ``b_rim`` that rime over a ``rime_density_kg_m3``) where
      ``T < ice_below_K`` and, in a share ``raining_of_cloudy`` of the
      cloudy columns, rain (``q_rai``, ``n_rai``) where
      ``T > rain_above_K``; contents are drawn uniformly and numbers
      log-uniformly in their ranges, 0 elsewhere;
    * the vapour is ``vapour_saturation_cloudy`` (cloudy columns) or
      ``vapour_saturation_clear`` times the saturation specific content
      over liquid where the point holds liquid or is no colder than
      ``ice_saturation_below_K``, over ice elsewhere, and ``q_tot`` the
      vapour plus the condensate;
    * ``inpc_log_shift`` is drawn per point from N(0,
      ``inpc_log_shift_sigma``^2).

    Every random number comes from one ``torch.Generator`` on ``device``,
    in a fixed order and in ``dtype``, so the same seed on the same device
    gives the same state."""
    recipe, nlev = config["state"], int(config["nlev"])
    g = generator(seed, device)
    kw = dict(device=device, dtype=dtype)
    shape = (ncol, nlev)

    def draw(size=shape):
        return torch.rand(size, generator=g, **kw)

    def uniform(lo_hi):
        lo, hi = lo_hi
        return draw() * (hi - lo) + lo

    def log_uniform(lo_hi):
        lo, hi = (math.log(v) for v in lo_hi)
        return torch.exp(draw() * (hi - lo) + lo)

    def profile(row):
        return row.to(**kw).expand(shape).contiguous()

    frac = torch.linspace(0.0, 1.0, nlev, dtype=torch.float64)
    (r0, r1), (t0, t1) = recipe["rho_kg_m3"], recipe["T_K"]
    f = {"rho": profile(r0 * (r1 / r0) ** frac),
         "T": profile(t0 + (t1 - t0) * frac)}
    T = f["T"]
    cloudy = draw((ncol, 1)) < recipe["cloudy_columns"]
    raining = cloudy & (draw((ncol, 1)) < recipe["raining_of_cloudy"])
    zero = torch.zeros((), **kw)
    where = {"lcl": cloudy & (T > recipe["liquid_above_K"]),
             "ice": cloudy & (T < recipe["ice_below_K"]),
             "rai": raining & (T > recipe["rain_above_K"])}
    for sp, mask in where.items():
        f[f"q_{sp}"] = torch.where(mask, uniform(recipe["uniform"][f"q_{sp}"]),
                                   zero)
        f[f"n_{sp}"] = torch.where(
            mask, log_uniform(recipe["log_uniform"][f"n_{sp}"]), zero)
    f["q_rim"] = f["q_ice"] * uniform(recipe["rime_fraction"])
    f["b_rim"] = f["q_rim"] / uniform(recipe["rime_density_kg_m3"])
    saturation = torch.where(cloudy, uniform(recipe["vapour_saturation_cloudy"]),
                             uniform(recipe["vapour_saturation_clear"]))
    tps = ThermodynamicsParameters()
    over_liquid = (f["q_lcl"] > 0) | (T >= recipe["ice_saturation_below_K"])
    q_sat = torch.where(
        over_liquid,
        thermo.saturation_vapor_specific_content_over_liquid(tps, T, f["rho"]),
        thermo.saturation_vapor_specific_content_over_ice(tps, T, f["rho"]))
    f["q_tot"] = saturation * q_sat + f["q_lcl"] + f["q_rai"] + f["q_ice"]
    del saturation, q_sat, where, over_liquid
    f["inpc_log_shift"] = torch.randn(shape, generator=g, **kw) * float(
        recipe["inpc_log_shift_sigma"])
    out = zero.expand(shape)
    return R.HostState(**{k: f[k] for k in R.HostState._fields[:12]},
                       **{k: out for k in R.RATES})


class Cell:
    """One host-step cell: ``config`` gives the grid and the state's recipe,
    ``workload`` the step (``quadrature_order``, ``dt``); ``ncol``
    overrides the grid's columns (tests). A carry is ``(state,
    loglambda)``: the :class:`~..reference.tendencies_p3.HostState` and the
    log lambda of the step that made it (None in the seeded state)."""

    # the eight rates, each against 1e-3 of its scale in the reference's
    # start step; log lambda against a tolerance of its own (ln of 1/m)
    groups = {"state_off": ("share", slice(0, NRATES)),
              "column_off": ("column", slice(0, NRATES)),
              "state_gap": ("gap", slice(0, NRATES)),
              "loglambda_off": ("off", slice(NRATES, NRATES + 1))}
    # what the tendency call launches; the host's shape solve is K5a,
    # column_p3_solve_kernel, and stays apart
    kernels = {"p3tend": ("column_p3_bounds_kernel",
                          "column_p3_nodes_kernel",
                          "column_p3_tend_rates_kernel")}

    def __init__(self, config: dict, workload: dict, device, ncol=None):
        # the route by name: a program without it fails here, at once
        from cloudmicrophysics_tpu_torch.kernels.column_p3 import (  # noqa: F401
            kernel_params_p3,
            loglambda_p3_fused,
            p3_tendencies_fused,
        )
        from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3
        from cloudmicrophysics_tpu_torch.models.tendencies import (
            bulk_microphysics_tendencies,
        )
        from cloudmicrophysics_tpu_torch.parameters import (
            ThermodynamicsParameters as ProgramTPS,
            microphysics_2m_params,
        )

        step = workload["step"]
        order = int(step["quadrature_order"])
        self.device = torch.device(device)
        self.config = config
        self.spec = workload["check"]
        self.ncol = int(ncol or config["ncol"])
        self.nlev = int(config["nlev"])
        self.points = self.ncol * self.nlev
        self.dtype = getattr(torch, config["dtype"])
        self.dt = float(step["dt"])
        self.mp = microphysics_2m_params(with_ice=True,
                                         quadrature_order=order)
        self.tps = ProgramTPS()
        block = kernel_params_p3(self.mp, self.tps, device=self.device,
                                 dtype=self.dtype)

        def solve(state, guess):
            return loglambda_p3_fused(
                ColumnStateP3(*state[:len(R.PROGNOSTIC)]), self.mp, self.tps,
                guess, params=block)

        self._solve = solve
        self._tendencies = bulk_microphysics_tendencies
        self.params = params_p3(order)
        self.seed = None

    def initial(self, seed: int):
        self.seed = seed
        return make_state(self.config, self.ncol, seed, self.device,
                          self.dtype), None

    def scales(self, initial) -> torch.Tensor:
        """Each rate's largest magnitude in the reference's start step over
        the checked columns (those the check draws from the run's seed);
        1 for log lambda, which is compared against a tolerance of its
        own."""
        columns = check.sample_columns(self.ncol, self.spec.get("columns"),
                                       self.seed)
        block = int(self.spec["block_columns"])
        dtype = check.DTYPES[self.config["reference_dtype"]]
        scale = None
        for lo in range(0, len(columns), block):
            cols = columns[lo:lo + block].to(initial[0].rho.device)
            with torch.no_grad():
                ref = self.reference(initial, cols, dtype)
            amax = ref[:NRATES].abs().flatten(1).amax(dim=1)
            scale = amax if scale is None else torch.maximum(scale, amax)
        return torch.cat([scale, torch.ones_like(scale[:1])])

    def restart(self, initial, start_out):
        """The carry an episode starts from: the seeded state, warm-started
        from the log lambda the start step found for it."""
        return initial[0], start_out[1]

    def step(self, carry):
        state, guess = carry
        return R.host_step(self._tendencies, self._solve, state, guess,
                           self.mp, self.tps, self.dt)

    def answers(self, carry, cols) -> torch.Tensor:
        state, loglam = carry
        return torch.stack([getattr(state, f)[cols] for f in R.RATES]
                           + [loglam[cols]])

    def reference(self, carry, cols, dtype) -> torch.Tensor:
        state, guess = carry
        sub = R.HostState(*(f[cols].to(dtype) for f in state))
        ref_guess = None if guess is None else guess[cols].to(dtype)
        new, loglam = R.step(sub, ref_guess, *self.params, self.dt)
        return torch.stack([getattr(new, f) for f in R.RATES] + [loglam])

    def finite(self, carry) -> bool:
        """Whether every field of the state and every rate is finite (log
        lambda is not finite where a point holds no ice)."""
        return all(bool(torch.isfinite(t).all()) for t in carry[0])
