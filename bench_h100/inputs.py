"""The cells' input states, made on the device from the seed.

One generator for every kind of column state, driven by the ``state``
recipe of the configuration file:

* ``profiles``: each named field runs linearly from its first value at
  the lowest level to its second at the highest (``rho``, ``T``);
* ``contents``: each named field is drawn uniformly in ``[lo, hi)``, with
  ``frozen_only`` fields set to 0 where ``T`` is at or above freezing
  (ice and snow are not drawn where they would melt);
* ``q_tot``: the vapour, ``vapour_saturation`` (drawn uniformly in
  ``[lo, hi)``) times the saturation specific content over liquid at the
  cell's ``T`` and ``rho``, plus every field listed in ``condensate``. So
  the vapour is what a host model's saturation adjustment leaves: about
  saturated, never negative, and the contents are its condensate.

Every random number comes from one ``torch.Generator`` on the state's
device, in one call and in the dtype the state is stepped in, so the same
seed on the same device gives the same state, and every seed the same
distribution of contents in another arrangement.
"""

from __future__ import annotations

import torch

from .reference.ops import thermo
from .reference.parameters.thermodynamics import ThermodynamicsParameters

T_FREEZE = 273.15


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def make_state(recipe: dict, fields, ncol: int, nlev: int, seed: int,
               device, dtype=torch.float32) -> torch.Tensor:
    """The state as one ``(len(fields), ncol, nlev)`` tensor, its rows in
    the order of ``fields``, drawn from ``seed`` by ``recipe`` (the
    configuration's ``state``)."""
    fields = list(fields)
    out = torch.empty((len(fields), ncol, nlev), device=device, dtype=dtype)
    for name, (bottom, top) in recipe["profiles"].items():
        row = torch.linspace(bottom, top, nlev, dtype=torch.float64)
        out[fields.index(name)] = row.to(device=device, dtype=dtype)
    contents = recipe["contents"]
    draws = torch.rand((len(contents) + 1, ncol, nlev),
                       generator=generator(seed, device), device=device,
                       dtype=dtype)
    T, rho = out[fields.index("T")], out[fields.index("rho")]
    frozen = recipe.get("frozen_only", [])
    for i, (name, (lo, hi)) in enumerate(contents.items()):
        row = out[fields.index(name)]
        torch.mul(draws[i], hi - lo, out=row)
        row += lo
        if name in frozen:
            row.masked_fill_(T >= T_FREEZE, 0.0)
    lo, hi = recipe["vapour_saturation"]
    q_sat = thermo.saturation_vapor_specific_content_over_liquid(
        ThermodynamicsParameters(), T, rho)
    q_tot = out[fields.index("q_tot")]
    torch.mul(draws[-1], hi - lo, out=q_tot)
    q_tot += lo
    q_tot *= q_sat
    for name in recipe["condensate"]:
        q_tot += out[fields.index(name)]
    return out
