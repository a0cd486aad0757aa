"""The harness on the CPU: finding files by name, the window's arithmetic,
the idle share, the refusal without a card, the result line."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from bench_h100 import harness
from bench_h100 import run as run_module

BENCH = Path(__file__).resolve().parents[1]


def test_cells_are_found_by_name():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        entry, workload, config, _ = harness.load_cell(w["name"])
        assert entry is not None and workload["name"] == w["name"]
        assert config["name"] == w["config"]
        assert hasattr(harness.load_driver(config["kind"]), "Cell")


def test_a_workload_added_as_a_file_is_found(tmp_path):
    root = tmp_path / "bench"
    (root / "workloads").mkdir(parents=True)
    (root / "configs").mkdir()
    shutil.copy(BENCH / "configs" / "atmos_1m.json", root / "configs")
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0],
                             file="bench/configs/atmos_1m.json")]
    bench["workloads"] = [{"name": "1m_new", "config": "atmos_1m",
                           "traffic": "inst_dt2", "chips": 1, "why": "x"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = json.loads((BENCH / "workloads" / "1m_inst.json").read_text())
    workload.update(name="1m_new", traffic="inst_dt2")
    workload["step"]["dt"] = 2.0
    (root / "workloads" / "1m_new.json").write_text(json.dumps(workload))
    entry, found, config, _ = harness.load_cell("1m_new", root)
    assert found["step"]["dt"] == 2.0 and config["kind"] == "column_1m"
    cell = harness.load_driver(config["kind"]).Cell(config, found, "cpu",
                                                    ncol=2)
    assert cell.dt == 2.0 and cell.points == 2 * config["nlev"]
    with pytest.raises(harness.BenchError):
        harness.load_cell("1m_inst", root)


def test_window_rate_and_tail_cover_every_step():
    steady = harness.window_metrics(1000, [1.0] * 100, 0.1)
    assert steady["points_per_s"] == pytest.approx(1e6)
    assert steady["step_ms_p95"] == pytest.approx(1.0)
    # a stall of ten steps of 20 ms moves the tail and the rate
    stalled = harness.window_metrics(1000, [1.0] * 90 + [20.0] * 10, 0.29)
    assert stalled["step_ms_p95"] == pytest.approx(20.0)
    assert stalled["points_per_s"] == pytest.approx(1e5 / 0.29)
    assert stalled["points_per_s"] < steady["points_per_s"]


def test_idle_share_on_synthetic_spans():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]   # busy 3 of 5 s
    assert harness.busy_seconds(spans) == pytest.approx(3.0)
    assert harness.idle_share(spans, 5.0) == pytest.approx(0.4)
    view = harness.TraceView([("k", a, b) for a, b in spans], [], 1, 5.0, 1,
                             {}, {})
    assert harness.load_metric("device.idle").read(view) == pytest.approx(0.4)
    gaps = harness.breakdown([("k", a, b) for a, b in spans],
                             [("bench.step", 2.1, 2.9)])
    assert gaps["idle_gaps"] == [["bench.step", pytest.approx(1.0)]]
    assert gaps["device_ops"] == [["k", pytest.approx(3.5)]]


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.BenchError):
        harness.run("1m_inst", 1, 1.0, False, 0.0)
    rc = run_module.main(["--workload", "1m_inst", "--seed", "1",
                          "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_run_with_too_few_cards_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(harness.BenchError):
        harness.run("1m_inst", 1, 1.0, False, 0.0)


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_keys(monkeypatch, trace):
    monkeypatch.setattr(harness, "SAMPLE_STEPS", 1)
    result = harness.run("1m_inst", 2**40 + 3, 0.2, trace, 0.0,
                         device="cpu", ncol=4)
    line = json.loads(harness.result_line(result))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    # the numbers compared, each beside its limit, under a last key
    assert list(line) == keys + ["checks"]
    assert set(line["checks"]) == {"state_off", "column_off", "nonfinite"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"points_per_s", "step_ms_p95",
                                        "setup_s"}
    assert line["attempted"] > 0


def test_infinite_gaps_print_as_strings():
    line = harness.result_line({"correct": False, "attempted": 1,
                                "failed": 1, "metrics": {}, "device": {},
                                "checks": {"state_gap": {
                                    "value": float("inf"), "limit": 1.0}}})
    assert json.loads(line)["checks"]["state_gap"]["value"] == "inf"
