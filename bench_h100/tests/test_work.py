"""Frozen work counts and the roofline arithmetic."""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from bench_h100 import harness, roofline

BENCH = Path(__file__).resolve().parents[1]


def test_bound_is_the_largest_of_the_three_times():
    work = {"flops_per_point": 669.0, "mufu_per_point": 4.18,
            "bytes_per_point": 33.5}
    # per point: 1e-11 s of float32, 1e-12 of MUFU, 1e-11 of bytes
    assert roofline.bound_seconds(work, 10**6) == pytest.approx(1e-5)
    work["mufu_per_point"] = 41.8 * 3
    assert roofline.bound_seconds(work, 10**6) == pytest.approx(3e-5)


def test_roofline_share_on_made_up_kernel_times():
    work = {"k1": {"flops_per_point": 669.0, "mufu_per_point": 0.0,
                   "bytes_per_point": 33.5}}
    # 1e6 points: bound 1e-5 s a step; 4 steps of K1 at 4e-5 s each
    kernels = [("void column1m_step_kernel<...>", 4e-5 * i, 4e-5 * (i + 1))
               for i in range(4)]
    kernels.append(("other_kernel", 1.0, 2.0))
    view = harness.TraceView(kernels, [1e-5] * 4, 4, 0.5, 10**6,
                             {"k1": ("column1m_step_kernel",)}, work)
    assert view.group_seconds("k1") == pytest.approx(1.6e-4)
    assert view.roofline_share("k1") == pytest.approx(25.0)
    assert harness.load_metric("k1_roofline").read(view) == pytest.approx(25)
    assert harness.load_metric("k1.ms").read(view) == pytest.approx(0.04)
    # no K5 here: its readers read nothing, never 0
    assert harness.load_metric("k5_roofline").read(view) is None
    assert harness.load_metric("k5.ms").read(view) is None


def test_a_reader_added_as_a_file_is_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "host.made_up.py").write_text(textwrap.dedent(
        """
        def read(view):
            return 2.0 * view.steps
        """))
    view = harness.TraceView([], [], 3, 1.0, 1, {}, {})
    assert harness.load_metric("host.made_up", tmp_path).read(view) == 6.0


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read), m["name"]


@pytest.mark.parametrize("cell", ["1m_linavg", "1m_inst", "p3_gl16",
                                  "p3_gl40"])
def test_workload_files_carry_frozen_work(cell):
    workload = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    group = "k1" if cell.startswith("1m") else "k5"
    work = workload["work"][group]
    assert work["bytes_per_point"] == (56 if group == "k1" else 96)
    assert work["flops_per_point"] > 0 and work["mufu_per_point"] > 0
    assert work["counted_on"]["build"] and work["counted_on"]["commit"]
