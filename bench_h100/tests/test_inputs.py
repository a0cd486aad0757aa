"""The seeded states: the same seed gives the same state, the vapour is
about saturated and never negative, and ice is drawn only below
freezing."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import harness, inputs
from bench_h100 import reference as R
from bench_h100.reference.ops import thermo
from bench_h100.reference.parameters.thermodynamics import (
    ThermodynamicsParameters,
)

SEED = 2**40 + 9


@pytest.mark.parametrize("cell", ["1m_inst", "p3_gl16"])
def test_the_state_follows_its_recipe(cell):
    _, _, config, _ = harness.load_cell(cell)
    fields = (R.ColumnState if config["kind"] == "column_1m"
              else R.ColumnStateP3)._fields
    recipe = config["state"]
    state = inputs.make_state(recipe, fields, 64, 24, SEED, "cpu",
                              torch.float64)
    assert torch.equal(state, inputs.make_state(recipe, fields, 64, 24,
                                                SEED, "cpu", torch.float64))
    assert not torch.equal(state, inputs.make_state(
        recipe, fields, 64, 24, SEED + 1, "cpu", torch.float64))
    row = dict(zip(fields, state))
    for name, (lo, hi) in recipe["contents"].items():
        drawn = row[name][row[name] != 0] if name in recipe[
            "frozen_only"] else row[name]
        assert drawn.min() >= lo and drawn.max() < hi, name
    for name in recipe["frozen_only"]:
        assert not row[name][row["T"] >= inputs.T_FREEZE].any(), name
    vapour = row["q_tot"] - sum(row[n] for n in recipe["condensate"])
    q_sat = thermo.saturation_vapor_specific_content_over_liquid(
        ThermodynamicsParameters(), row["T"], row["rho"])
    lo, hi = recipe["vapour_saturation"]
    ratio = vapour / q_sat
    assert ratio.min() >= lo - 1e-12 and ratio.max() < hi + 1e-12
    assert torch.equal(row["T"][0], row["T"][-1])      # the same profile
