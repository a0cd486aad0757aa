"""The host-step cell ``p3_tend_gl40`` (kind ``p3_tendencies``) on the CPU:
its seeded state, its check's groups, its reference's imports and a short
run through the plain path."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_h100 import harness
from bench_h100.drivers import p3_tendencies as D
from bench_h100.reference import tendencies_p3 as R

from .test_no_jax import FORBIDDEN, ROOT

SEED = 2**33 + 26


def _config(nlev=63):
    config = harness.load_cell("p3_tend_gl40")[2]
    return dict(config, nlev=nlev)


@pytest.fixture(scope="module")
def state():
    return D.make_state(_config(), 2048, SEED, "cpu")


def test_the_recipe_places_each_hydrometeor(state):
    recipe = _config()["state"]
    T = state.T
    condensate = (state.q_lcl > 0) | (state.q_ice > 0)
    cloudy = condensate.any(dim=1)
    # half of the columns cloudy, each a cloudy column at every level
    assert abs(float(cloudy.float().mean()) - recipe["cloudy_columns"]) < 0.04
    assert bool(condensate[cloudy].all())
    assert not bool(condensate[~cloudy].any())
    # liquid only above 248 K, ice only below 268 K, rain only above
    # freezing, each with its number
    assert bool((T[state.q_lcl > 0] > recipe["liquid_above_K"]).all())
    assert bool((T[state.q_ice > 0] < recipe["ice_below_K"]).all())
    assert bool((T[state.q_rai > 0] > recipe["rain_above_K"]).all())
    for q, n in ((state.q_lcl, state.n_lcl), (state.q_rai, state.n_rai),
                 (state.q_ice, state.n_ice)):
        assert torch.equal(q > 0, n > 0)
    # rain in about a third of the cloudy columns
    raining = (state.q_rai > 0).any(dim=1)
    share = float(raining.float().sum() / cloudy.float().sum())
    assert abs(share - recipe["raining_of_cloudy"]) < 0.05
    # rime within the ice, its volume at a density of 100-900 kg/m3
    assert bool((state.q_rim <= state.q_ice).all())
    rimed = state.q_rim > 0
    density = state.q_rim[rimed] / state.b_rim[rimed]
    assert float(density.min()) >= 100 * (1 - 1e-6)
    assert float(density.max()) <= 900 * (1 + 1e-6)
    # ice in about a third of the points, mixed-phase points among them
    assert 0.25 < float((state.q_ice > 0).float().mean()) < 0.45
    assert bool(((state.q_ice > 0) & (state.q_lcl > 0)).any())
    # the INP shift's spread, the rates zero, the profiles' ends
    assert abs(float(state.inpc_log_shift.std()) - 1.37) < 0.02
    for name in R.RATES:
        assert not bool(getattr(state, name).any())
    assert torch.allclose(state.rho[0, [0, -1]],
                          torch.tensor([1.2, 0.15]))
    assert torch.allclose(state.T[0, [0, -1]], torch.tensor([295.0, 210.0]))
    assert bool((state.q_tot >= state.q_lcl + state.q_rai + state.q_ice).all())


def test_the_same_seed_gives_the_same_state():
    a = D.make_state(_config(16), 64, SEED, "cpu")
    b = D.make_state(_config(16), 64, SEED, "cpu")
    c = D.make_state(_config(16), 64, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.q_lcl, c.q_lcl)


def test_the_check_groups_cover_the_rates_and_log_lambda():
    groups = D.Cell.groups
    rows = range(len(R.RATES) + 1)
    assert [rows[groups[g][1]] for g in ("state_off", "column_off",
                                         "state_gap")] == [rows[:8]] * 3
    assert rows[groups["loglambda_off"][1]] == rows[8:9]
    workload = harness.load_cell("p3_tend_gl40")[1]
    assert set(workload["check"]["limits"]) <= set(groups)
    assert workload["check"]["columns"] == 1024


def test_the_workload_file_carries_frozen_work():
    workload = harness.load_cell("p3_tend_gl40")[1]
    work = workload["work"]["p3tend"]
    # eleven fields, log lambda and the INP shift read, eight rates written
    assert work["bytes_per_point"] == 21 * 4
    assert work["flops_per_point"] > 0 and work["mufu_per_point"] > 0
    assert work["counted_on"]["build"] and work["counted_on"]["commit"]
    assert workload["step"]["dt"] == 1.0


def test_reference_loads_nothing_of_the_program():
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             "import bench_h100.reference.tendencies_p3; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {*FORBIDDEN, "cloudmicrophysics_tpu_torch"}


def test_a_run_on_the_plain_path_agrees_with_the_reference():
    # the program's eager tendencies are the frozen ones, op for op: every
    # check reads 0 and the kernel group names the tendency build's kernels
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from bench_h100 import harness; harness.SAMPLE_STEPS = 1; "
            "import json; r = harness.run('p3_tend_gl40', 7, 0.05, False, "
            "0.0, device='cpu', ncol=2); print(json.dumps(r['checks']), "
            "r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    checks, correct = out.stdout.strip().splitlines()[-1].rsplit(" ", 1)
    assert correct == "True"
    assert all(c["value"] == 0 for c in json.loads(checks).values())
    assert set(D.Cell.kernels) == {"p3tend"}
