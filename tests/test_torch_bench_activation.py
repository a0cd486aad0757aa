"""The benchmark's frozen ARG2000 activation step
(``bench_h100/reference/activation.py`` on ``reference/ops/
aerosol_activation.py``) and the cell ``arg_mam4`` on the CPU:

* the frozen activation against the JAX package's
  ``ops/aerosol_activation`` at float64 on the cell's recipe (MAM4's four
  modes with per-point ``(ncol, nlev)`` fields), at rtol 1e-9 with an
  absolute floor of 1e-15 of each answer's largest value: a mode's
  activated number is ``N (1 - erf(u)) / 2``, which cancels for large
  ``u``, and torch's and XLA's erf differ there by a unit in the last
  place, a few 1e-17 of ``N``;
* the program's step (the port's ``N_activated_per_mode`` and
  ``M_activated_per_mode``, the host update) against the frozen step bit
  for bit at float32 and float64: the frozen copy is the port's,
  term for term and in the same order;
* a CPU run of the cell is correct with every gap 0 (in a process of its
  own: the harness refuses to report with JAX loaded);
* the cell's check is tight enough: a bfloat16 state, a step that drops
  the condensation-sink correction and a step that leaves out the coarse
  mode each fail one of its limits;
* the program's spans open once a call, and a step computes S_max twice
  a point (``activation.smax_points`` twice ``activation.points``);
* the frozen step imports neither JAX nor the port.
"""

import dataclasses
import json
import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
from cloudmicrophysics_tpu.ops import aerosol_activation as JAA
from cloudmicrophysics_tpu.parameters import aerosol as JPA
from cloudmicrophysics_tpu_torch import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import check, harness  # noqa: E402
from bench_h100.drivers import activation as D  # noqa: E402
from bench_h100.reference import activation as R  # noqa: E402
from bench_h100.reference.ops import aerosol_activation as RAA  # noqa: E402

CELL = ROOT / "bench_h100" / "workloads" / "arg_mam4.json"
CONFIG = ROOT / "bench_h100" / "configs" / "atmos_mam4.json"
SEED = 2**35 + 211
NCOL = 64
RTOL, ATOL_REL = 1e-9, 1e-15


def _config():
    return json.loads(CONFIG.read_text())


def _state(ncol=NCOL, seed=SEED, dtype=torch.float64):
    """The cell's state at ``ncol`` columns, stepped once by the frozen
    step, so that ``N_liq`` holds a step's droplets."""
    cfg = _config()
    layout = R.Layout(cfg)
    state = D.make_state(cfg, ncol, seed, "cpu", dtype)
    n_act, m_act, N_liq = R.step(layout, state, *R.params())
    return layout, layout.with_outputs(state, n_act, m_act, N_liq)


def _jax_distribution(layout, state):
    modes = []
    for m in layout.modes:
        n, sp = m["name"], m["species"]

        def field(name):
            return jnp.asarray(getattr(state, name).numpy())

        modes.append(JPA.ModeKappa(
            r_dry=field(f"r_dry_{n}"), stdev=m["stdev"], N=field(f"N_{n}"),
            vol_mix_ratio=tuple(field(f"vol_{n}_{s}") for s in sp),
            mass_mix_ratio=tuple(field(f"mass_{n}_{s}") for s in sp),
            molar_mass=tuple(layout.species[s]["molar_mass"] for s in sp),
            kappa=tuple(layout.species[s]["kappa"] for s in sp)))
    return JPA.AerosolDistribution(modes=tuple(modes))


@pytest.mark.parametrize("name", ["max_supersaturation",
                                  "N_activated_per_mode",
                                  "M_activated_per_mode"])
def test_frozen_activation_is_the_jax_package_at_float64(name):
    layout, state = _state()
    air = layout.air(state)
    got = getattr(RAA, name)(*R.params()[:1], layout.distribution(state),
                             *R.params()[1:], *air)
    want = getattr(JAA, name)(
        JPA.AerosolActivationParameters(), _jax_distribution(layout, state),
        JP.AirProperties(), JP.ThermodynamicsParameters(),
        *(jnp.asarray(a.numpy()) for a in air))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape == (NCOL, 72)
        atol = ATOL_REL * float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=atol,
                                   err_msg=f"{name}[{i}]")


def test_the_recipe_draws_the_configured_state():
    cfg = _config()
    layout = R.Layout(cfg)
    state = D.make_state(cfg, 256, SEED, "cpu")
    assert len(layout.inputs) == 58 and len(layout.answers) == 9
    s = state._asdict()
    cloudy = s["q_liq"] > 0
    assert 0.27 < float(cloudy.float().mean()) < 0.33
    assert bool(((s["N_liq"] > 0) == cloudy).all())
    N = s["N_liq"][cloudy]
    assert 1e7 <= float(N.min()) and float(N.max()) <= 3e8
    assert bool((s["q_ice"][s["T"] >= 263.0] == 0).all())
    assert float(s["w"].min()) >= 0.2 and float(s["w"].max()) <= 2.0
    assert float(s["T"][:, 0].min()) == pytest.approx(298.0)
    assert float(s["T"][:, -1].max()) == pytest.approx(210.0)
    for m in cfg["modes"]:
        n = m["name"]
        lo, hi = m["N_per_m3"]
        assert lo * 0.999 <= float(s[f"N_{n}"].min())
        assert float(s[f"N_{n}"].max()) <= hi * 1.001
        lo, hi = m["r_dry_m"]
        assert lo * 0.999 <= float(s[f"r_dry_{n}"].min())
        assert float(s[f"r_dry_{n}"].max()) <= hi * 1.001
        for kind in ("vol", "mass"):
            total = sum(s[f"{kind}_{n}_{sp}"] for sp in m["species"])
            assert torch.allclose(total, torch.ones_like(total), atol=1e-6)
    again = D.make_state(cfg, 256, SEED, "cpu")
    other = D.make_state(cfg, 256, SEED + 1, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(state, again))
    assert not torch.equal(state.N_aitken, other.N_aitken)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_program_step_is_the_frozen_step_bit_for_bit(dtype):
    cfg = _config()
    cell = D.Cell(cfg, json.loads(CELL.read_text()), "cpu", 32)
    carry = (D.make_state(cfg, 32, SEED + 2, "cpu", dtype), None)
    cols = torch.arange(32)
    for _ in range(3):
        out = cell.step(carry)
        got = cell.answers(out, cols)
        want = cell.reference(carry, cols, dtype)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        carry = out


def _seed_with_early_sample(base):
    """A large seed whose checked window step comes within the first
    three, so that a short CPU window reaches it."""
    seed = base
    while random.Random(seed).randint(1, harness.SAMPLE_STEPS) > 3:
        seed += 1
    return seed


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from bench_h100 import harness
result = harness.run("arg_mam4", {seed}, 0.5, {trace}, time.perf_counter(),
                     device="cpu", ncol=16)
print("RESULT", json.dumps(result, default=str))
"""


@pytest.mark.parametrize("trace_run", [False, True])
def test_a_cpu_run_of_the_cell_is_correct_with_no_gap(trace_run):
    seed = _seed_with_early_sample(2**33 + 17)
    script = _RUN.format(root=str(ROOT), seed=seed, trace=trace_run)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")]
    result = json.loads(line[-1][len("RESULT"):])
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    if trace_run:
        # the program's spans and counters; no device kernels on the CPU
        metrics = result["metrics"]
        assert metrics["activation.smax_evals"]["value"] == 2.0
        assert metrics["activation.host_ms"]["value"] > 0
        assert {"host.enqueue_ms", "setup.program_s"} <= set(metrics)
    else:
        assert set(result["metrics"]) == {"points_per_s", "step_ms_p95",
                                          "setup_s"}


def _faulty(layout, state, dtype=torch.float32, sink=True, coarse=True):
    """The frozen step's answers with one fault: a lower ``dtype``, no
    condensation sink (no preexisting liquid or ice: ``K_liq = K_ice =
    0``), or no coarse mode (its rows 0, the other modes activated
    without it)."""
    st = layout.State(**{f: getattr(state, f).to(dtype)
                         for f in layout.inputs},
                      **{f: None for f in layout.outputs})
    ad = layout.distribution(st)
    names = [m["name"] for m in layout.modes]
    if not coarse:
        ad = dataclasses.replace(ad, modes=tuple(
            m for m, n in zip(ad.modes, names) if n != "coarse"))
    air = list(layout.air(st))
    if not sink:
        air[6], air[7] = torch.zeros_like(air[6]), torch.zeros_like(air[7])
    ap, aip, tps = R.params()
    n_act = list(RAA.N_activated_per_mode(ap, ad, aip, tps, *air))
    m_act = list(RAA.M_activated_per_mode(ap, ad, aip, tps, *air))
    if not coarse:
        i = names.index("coarse")
        n_act.insert(i, torch.zeros_like(n_act[0]))
        m_act.insert(i, torch.zeros_like(m_act[0]))
    N_liq = R.host_update(st.q_liq, st.N_liq, n_act)
    return torch.stack(n_act + m_act + [N_liq])


@pytest.mark.parametrize("fault", ["bfloat16", "no condensation sink",
                                   "no coarse mode"])
def test_the_cells_check_fails_each_fault(fault):
    cfg = _config()
    spec = json.loads(CELL.read_text())["check"]
    cell = D.Cell(cfg, json.loads(CELL.read_text()), "cpu", 256)
    initial = cell.initial(SEED + 3)
    carry = cell.step(cell.step(initial))
    layout, state = cell.layout, carry[0]
    reference = _faulty(layout, state)
    kw = {"bfloat16": dict(dtype=torch.bfloat16),
          "no condensation sink": dict(sink=False),
          "no coarse mode": dict(coarse=False)}[fault]

    def gaps(program):
        acc = check.GapSum(D.Cell.groups, spec["tolerance"],
                           cell.scales(initial))
        acc.add(program, reference)
        return acc.gaps()

    sound = gaps(cell.answers(cell.step(carry), torch.arange(256)))
    assert all(sound[g] == 0 for g in spec["limits"]), sound
    bad = gaps(_faulty(layout, state, **kw))
    assert [g for g, limit in spec["limits"].items()
            if not bad[g] <= limit], bad


def test_spans_open_once_a_call_and_smax_twice_a_point():
    from torch.profiler import ProfilerActivity, profile

    cfg = _config()
    cell = D.Cell(cfg, json.loads(CELL.read_text()), "cpu", 8)
    carry = cell.initial(SEED + 4)
    names = ("activation.points", "activation.smax_points",
             "activation.mode_points")
    before = {n: trace.counter(n) for n in names}
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        cell.step(carry)
    totals = trace.totals()
    assert totals["activation.number"]["count"] == 1
    assert totals["activation.mass"]["count"] == 1
    assert totals["activation.smax"]["count"] == 2
    # activation.smax is a child of both entries
    for outer in ("activation.number", "activation.mass"):
        assert totals[outer]["self_ns"] < totals[outer]["total_ns"]
    added = {n: trace.counter(n) - before[n] for n in names}
    points = 8 * cfg["nlev"]
    assert added["activation.points"] == points
    assert added["activation.smax_points"] == 2 * points
    assert added["activation.mode_points"] == 4 * points
    trace.reset()


_NO_JAX = """
import sys
sys.path.insert(0, {root!r})
import json
import torch
from bench_h100.drivers import activation as D
from bench_h100.reference import activation as R
cfg = json.load(open({config!r}))
layout = R.Layout(cfg)
state = D.make_state(cfg, 4, 5, "cpu")
n_act, m_act, N_liq = R.step(layout, state, *R.params())
assert all(bool(torch.isfinite(t).all()) for t in (*n_act, *m_act, N_liq))
loaded = sorted({{m.split(".")[0] for m in sys.modules}}
                & {{"jax", "jaxlib", "flax", "cloudmicrophysics_tpu",
                    "cloudmicrophysics_tpu_torch"}})
print("LOADED", loaded)
"""


def test_frozen_step_imports_neither_jax_nor_the_port():
    script = _NO_JAX.format(root=str(ROOT), config=str(CONFIG))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
