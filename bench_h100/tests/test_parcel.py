"""The parcel cell on the CPU: the frozen reference is the program's parcel
step bit for bit; a run through the harness at a few members is correct,
and each fault a run can have makes it not correct; its closed loop stays
finite; and the readers of the program's spans and counters read a
registry made up here, and nothing from a program without one.

``BENCHMARK.json`` does not list the cell (its runs spread too widely for
the benchmark's bounds, PERF.md §7): the tests list it in a
``BENCHMARK.json`` of their own, beside this folder."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from bench_h100 import harness, spans
from bench_h100.drivers import parcel as D
from bench_h100.reference.models import parcel as R
from bench_h100.tests.test_faults import altered, unchanged

BENCH = Path(__file__).resolve().parents[1]
CELL = "parcel_tully_16k"
SEED = 2**35 + 29
CONFIG = {"name": "parcel_ensemble", "source": "see the file",
          "file": "bench_h100/configs/parcel_ensemble.json",
          "reduced": ["periods"], "why": "the parcel cell"}
ENTRY = {"name": CELL, "config": "parcel_ensemble", "traffic": "tully_period1",
         "chips": 1, "why": "the parcel cell"}
METRIC = {"name": "parcel.processes_ms", "unit": "ms", "better": "lower",
          "source": "program_span", "layer": "parcel",
          "moves": "points_per_s", "workloads": [CELL]}


@pytest.fixture(autouse=True)
def _listed(tmp_path, monkeypatch):
    """The harness finds the cell in a ``BENCHMARK.json`` that lists it,
    beside this folder; the checked window step is the first."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"].append(CONFIG)
    bench["workloads"].append(ENTRY)
    bench["per_layer"].append(METRIC)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "bench_h100").symlink_to(BENCH)
    load = harness.load_cell
    monkeypatch.setattr(harness, "load_cell",
                        lambda name, root=None: load(name,
                                                     tmp_path / "bench_h100"))
    monkeypatch.setattr(harness, "SAMPLE_STEPS", 1)


def half(step):
    """A step that advances the first half of the members and leaves the
    rest as they were."""
    def faulty(carry):
        out = step(carry)
        n = carry[1].shape[0] // 2
        state = type(carry[0])(*(torch.cat([o[:n], c[n:]])
                                 for o, c in zip(out[0], carry[0])))
        return state, out[1]
    return faulty


def _cell(members, device="cpu", dtype=None):
    _, workload, config, _ = harness.load_cell(CELL)
    if dtype is not None:
        config = dict(config, dtype=dtype)
    return D.Cell(config, workload, torch.device(device), ncol=members)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_is_the_program_step_bit_for_bit(dtype):
    cell = _cell(32, dtype=dtype)
    carry = cell.initial(SEED)
    cols = torch.arange(cell.ncol)
    for _ in range(400):      # past the first members' nucleation
        out = cell.step(carry)
        ref = cell.reference(carry, cols, getattr(torch, dtype))
        assert torch.equal(cell.answers(out, cols), ref)
        carry = out
    assert bool((carry[0].N_ice > 0).any())


def test_the_updrafts_come_from_the_seed():
    cell = _cell(64)
    _, w = cell.initial(SEED)
    assert float(w[0]) == pytest.approx(0.035)
    assert float(w[1:].min()) >= 0.01 and float(w[1:].max()) <= 1.0
    assert torch.equal(w, cell.initial(SEED)[1])
    assert not torch.equal(w, cell.initial(SEED + 1)[1])
    scales = cell.scales(cell.initial(SEED))
    by_name = dict(zip(R.ParcelState._fields, scales.tolist()))
    assert by_name["q_ice"] == by_name["q_vap"] == pytest.approx(3.3e-4)
    assert by_name["N_ice"] == by_name["N_aer"] == 2e6
    assert by_name["ln_inpc"] == 1.0


def test_a_sound_run_is_correct():
    result = harness.run(CELL, SEED, 0.5, False, 0.0, device="cpu", ncol=64)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"points_per_s", "step_ms_p95",
                                      "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half, altered])
def test_a_broken_step_is_not_correct(fault):
    result = harness.run(CELL, SEED, 0.5, False, 0.0, device="cpu", ncol=64,
                         fault=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_a_traced_run_reads_the_program_spans():
    from cloudmicrophysics_tpu_torch import trace

    trace.reset()
    result = harness.run(CELL, SEED, 0.5, True, 0.0, device="cpu", ncol=16)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"step.host_ms", "parcel.processes_ms", "setup.program_s",
            "host.enqueue_ms"} <= set(metrics)
    assert "step.launch_ms" not in metrics     # not one of its cells
    assert 0 < metrics["parcel.processes_ms"] < metrics["step.host_ms"]
    assert metrics["step.host_ms"] <= metrics["host.enqueue_ms"]
    trace.reset()


def test_the_loop_stays_finite():
    cell = _cell(8)
    carry = cell.restart(cell.initial(SEED), None)
    for i in range(2000):
        carry = cell.step(carry)
    assert cell.finite(carry)


class _Registry:
    """A made-up program registry."""

    def __init__(self, totals, counters):
        self._totals, self._counters = totals, counters

    def totals(self):
        return self._totals

    def counter(self, name):
        return self._counters.get(name, 0)


def _span(count, total_ns):
    return {"count": count, "total_ns": total_ns, "self_ns": total_ns // 2}


def test_the_span_readers_read_a_made_up_registry(monkeypatch):
    registry = _Registry(
        {"step.column_p3": _span(10, 5_000_000),
         "step.parcel": _span(10, 20_000_000),
         "column.prepare": _span(10, 1_000_000),
         "launch.k5a": _span(10, 300_000), "launch.k5b": _span(10, 200_000),
         "parcel.thermo": _span(10, 4_000_000),
         "parcel.deposition": _span(10, 3_000_000),
         "parcel.deposition_growth": _span(10, 2_000_000),
         "parcel.update": _span(10, 6_000_000)},
        {"kernels.build_s": 1.5, "kernels.load_s": 0.25,
         "setup.params_s": 0.125, "kernels.loads": 3})
    monkeypatch.setattr(spans, "registry", lambda: registry)
    view = harness.TraceView([], [], 10, 1.0, 1, {}, {})
    read = {name: harness.load_metric(name).read(view)
            for name in ("step.host_ms", "step.launch_ms",
                         "parcel.processes_ms", "setup.program_s")}
    assert read["step.host_ms"] == pytest.approx(2.5)
    assert read["step.launch_ms"] == pytest.approx(0.05)
    assert read["parcel.processes_ms"] == pytest.approx(0.5)
    assert read["setup.program_s"] == pytest.approx(1.875)
    # spans the program did not record read nothing, never 0
    monkeypatch.setattr(spans, "registry", lambda: _Registry({}, {}))
    assert harness.load_metric("step.host_ms").read(view) is None
    assert harness.load_metric("parcel.processes_ms").read(view) is None
    assert harness.load_metric("setup.program_s").read(view) == 0.0


def test_a_program_without_a_registry_reads_nothing(monkeypatch):
    import cloudmicrophysics_tpu_torch as program

    monkeypatch.delattr(program, "trace")
    monkeypatch.setitem(sys.modules, "cloudmicrophysics_tpu_torch.trace",
                        None)
    assert spans.registry() is None
    view = harness.TraceView([], [], 10, 1.0, 1, {}, {})
    for name in ("step.host_ms", "step.launch_ms", "parcel.processes_ms",
                 "setup.program_s"):
        assert harness.load_metric(name).read(view) is None
