"""Kind ``activation``: a host model's droplet-activation call on every
grid point, through the program's public ``N_activated_per_mode`` and
``M_activated_per_mode`` with an ``AerosolDistribution`` of per-point
``(ncol, nlev)`` tensors, then ``N_liq <- max(N_liq, sum of N_act)`` at
cloudy points (``reference/activation.py:host_update``), stepped in a closed
loop: the next step's input is the state with that ``N_liq``, so the
condensation sink sees the droplets the last step made. The reference is
the frozen ARG2000 of ``reference/ops/aerosol_activation.py`` with the same
host update.

The state is drawn from the seed by :func:`make_state`, not from a
simulation."""

from __future__ import annotations

import math

import torch

from ..inputs import generator
from ..reference import activation as R
from ..reference.ops import thermo
from ..reference.parameters.thermodynamics import ThermodynamicsParameters


def make_state(config: dict, ncol: int, seed: int, device,
               dtype=torch.float32):
    """The inputs of ``config``'s :class:`~..reference.activation.Layout`
    drawn from ``seed`` by ``config["state"]`` and ``config["modes"]``, and
    the outputs zero (a broadcast zero, never written). Level k of
    ``config["nlev"]`` lies at height ``(k + 1/2) top_m / nlev``:

    * ``T`` runs linearly from its first value at the lowest level to its
      second at the highest, ``p`` falls from ``p_surface_pa`` as
      ``exp(-z / scale_height_m)``;
    * ``w`` is log-uniform in its range;
    * a share ``cloudy_points`` of the points is cloudy, with ``q_liq`` and
      ``N_liq`` uniform in their ranges (0 elsewhere);
    * a share ``ice_of_cold_points`` of the points colder than
      ``ice_below_K`` holds ice, ``q_ice`` uniform and ``N_ice``
      log-uniform in their ranges (0 elsewhere);
    * the vapour is ``vapour_saturation_cloudy`` (cloudy points) or
      ``vapour_saturation_clear`` times the saturation specific humidity
      over liquid at ``T`` and ``p``, and ``q_tot`` the vapour plus
      ``q_liq`` and ``q_ice``;
    * each mode's ``N`` and ``r_dry`` are log-uniform in its ranges, its
      species' volume fractions uniform and normalised, and their mass
      fractions the volumes weighted by each species' density, normalised.

    Every random number comes from one ``torch.Generator`` on ``device``,
    one ``(ncol, nlev)`` draw at a time in a fixed order and in ``dtype``,
    so the same seed on the same device gives the same state."""
    layout = R.Layout(config)
    recipe, nlev = config["state"], int(config["nlev"])
    g = generator(seed, device)
    kw = dict(device=device, dtype=dtype)

    def draw():
        return torch.rand((ncol, nlev), generator=g, **kw)

    def uniform(lo_hi):
        lo, hi = lo_hi
        return draw() * (hi - lo) + lo

    def log_uniform(lo_hi):
        lo, hi = (math.log(v) for v in lo_hi)
        return torch.exp(draw() * (hi - lo) + lo)

    def profile(row):
        return row.to(**kw).expand(ncol, nlev).contiguous()

    z = ((torch.arange(nlev, dtype=torch.float64) + 0.5)
         * recipe["top_m"] / nlev)
    f = {"T": profile(torch.linspace(*recipe["T_K"], nlev,
                                     dtype=torch.float64)),
         "p": profile(recipe["p_surface_pa"]
                      * torch.exp(-z / recipe["scale_height_m"]))}
    f["w"] = log_uniform(recipe["w_m_per_s"])
    zero = torch.zeros((), **kw)
    cloudy = draw() < recipe["cloudy_points"]
    f["q_liq"] = torch.where(cloudy, uniform(recipe["q_liq"]), zero)
    f["N_liq"] = torch.where(cloudy, uniform(recipe["N_liq_per_m3"]), zero)
    ice = (f["T"] < recipe["ice_below_K"]) & (
        draw() < recipe["ice_of_cold_points"])
    f["q_ice"] = torch.where(ice, uniform(recipe["q_ice"]), zero)
    f["N_ice"] = torch.where(ice, log_uniform(recipe["N_ice_per_m3"]), zero)
    saturation = torch.where(cloudy,
                             uniform(recipe["vapour_saturation_cloudy"]),
                             uniform(recipe["vapour_saturation_clear"]))
    del cloudy, ice
    tps = ThermodynamicsParameters()
    p_vs = thermo.saturation_vapor_pressure_over_liquid(tps, f["T"])
    eps = tps.R_d / tps.R_v
    q_sat = eps * p_vs / (f["p"] - (1 - eps) * p_vs)
    f["q_tot"] = saturation * q_sat + f["q_liq"] + f["q_ice"]
    del saturation, p_vs, q_sat

    for m in config["modes"]:
        n = m["name"]
        f[f"N_{n}"] = log_uniform(m["N_per_m3"])
        f[f"r_dry_{n}"] = log_uniform(m["r_dry_m"])
        vol = [draw() for _ in m["species"]]
        total = sum(vol)
        vol = [v / total for v in vol]
        heavy = [v * config["species"][s]["density"]
                 for v, s in zip(vol, m["species"])]
        total = sum(heavy)
        for s, v, h in zip(m["species"], vol, heavy):
            f[f"vol_{n}_{s}"] = v
            f[f"mass_{n}_{s}"] = h / total
        del vol, heavy, total
    out = zero.expand(ncol, nlev)
    return layout.State(**{k: f[k] for k in layout.inputs},
                        **{k: out for k in layout.outputs})


class Cell:
    """One activation cell: ``config`` gives the grid, the mode table and
    the state's recipe; ``ncol`` overrides the grid's columns (tests). A
    carry is ``(state, None)``, the state a flat named tuple of
    ``(ncol, nlev)`` fields (:class:`~..reference.activation.Layout`), so
    that the harness's tools take it as they take a column carry."""

    groups = {"state_off": ("share", slice(None)),
              "column_off": ("column", slice(None)),
              "state_gap": ("gap", slice(None))}
    # every kernel of a step: torch's eager elementwise kernels
    # (vectorized_elementwise_kernel, unrolled_elementwise_kernel,
    # elementwise_kernel), ARG2000's and the host update's alike
    kernels = {"arg": ("elementwise_kernel",)}

    def __init__(self, config: dict, workload: dict, device, ncol=None):
        from cloudmicrophysics_tpu_torch.ops import aerosol_activation
        from cloudmicrophysics_tpu_torch.parameters import (
            AirProperties,
            ThermodynamicsParameters as ProgramTPS,
        )
        from cloudmicrophysics_tpu_torch.parameters.aerosol import (
            AerosolActivationParameters,
            AerosolDistribution,
            ModeKappa,
        )

        self.device = torch.device(device)
        self.config = config
        self.ncol = int(ncol or config["ncol"])
        self.nlev = int(config["nlev"])
        self.points = self.ncol * self.nlev
        self.dtype = getattr(torch, config["dtype"])
        self.layout = R.Layout(config)
        self._aa = aerosol_activation
        self._classes = (ModeKappa, AerosolDistribution)
        self._params = (AerosolActivationParameters(), AirProperties(),
                        ProgramTPS())
        self.params = R.params()

    def initial(self, seed: int):
        return make_state(self.config, self.ncol, seed, self.device,
                          self.dtype), None

    def scales(self, initial) -> torch.Tensor:
        """Each answer's scale in the seeded state: a mode's largest ``N``
        for its activated number, its largest molar-mass-weighted mass
        fraction (``M_activated_per_mode``'s whole-mode value) for its
        activated mass, the largest ``N_liq`` for ``N_liq``."""
        s = initial[0]
        numbers, masses = [], []
        for m in self.layout.modes:
            n = m["name"]
            numbers.append(getattr(s, f"N_{n}").abs().amax())
            whole = sum(self.layout.species[sp]["molar_mass"]
                        * getattr(s, f"mass_{n}_{sp}")
                        for sp in m["species"])
            masses.append(whole.abs().amax())
        return torch.stack(numbers + masses + [s.N_liq.abs().amax()])

    def restart(self, initial, start_out):
        """The carry an episode starts from: the seeded state."""
        return initial

    def step(self, carry):
        state, _ = carry
        ad = self.layout.distribution(state, *self._classes)
        n_act, m_act, N_liq = R.activation_step(
            self._aa, self.layout, state, *self._params, ad)
        return self.layout.with_outputs(state, n_act, m_act, N_liq), None

    def answers(self, carry, cols) -> torch.Tensor:
        return torch.stack([getattr(carry[0], f)[cols]
                            for f in self.layout.answers])

    def reference(self, carry, cols, dtype) -> torch.Tensor:
        state = carry[0]
        inputs = {f: getattr(state, f)[cols].to(dtype)
                  for f in self.layout.inputs}
        sub = self.layout.State(**inputs,
                                **{f: None for f in self.layout.outputs})
        n_act, m_act, N_liq = R.step(self.layout, sub, *self.params)
        return torch.stack(list(n_act) + list(m_act) + [N_liq])

    def finite(self, carry) -> bool:
        return all(bool(torch.isfinite(getattr(carry[0], f)).all())
                   for f in self.layout.answers)
