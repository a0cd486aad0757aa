"""The port's spans and counters (cloudmicrophysics_tpu_torch/trace.py), on
the CPU: with no profiler recording a step records nothing and never calls
``record_function``; under a CPU ``torch.profiler`` the spans lie in the
profiler's events with their names and nesting, and their totals add up;
counters count; the libraries' build and load counters; the 2M path's
spans (the launch path through a stand-in library); ``parcel_step``
looped is ``run_parcel`` bit for bit."""

import dataclasses
import stat
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.examples.common import parcel_ic
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.kernels import column1m as K1
from cloudmicrophysics_tpu_torch.kernels import column2m as K2
from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
from cloudmicrophysics_tpu_torch.models import column as C
from cloudmicrophysics_tpu_torch.models import parcel as PM
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters,
    microphysics_1m_params,
    microphysics_2m_params,
    terminal_velocity_params,
)
from cloudmicrophysics_tpu_torch.parameters.aerosol_species import DesertDust

TPS = ThermodynamicsParameters()
MEMBERS = 6
FAMILIES = ("parcel.deposition", "parcel.deposition_growth")


def _column_state(fields, n=8, k=6, dtype=torch.float32):
    rng = np.random.default_rng(5)
    base = dict(rho=np.linspace(1.2, 0.5, k) * np.ones((n, 1)),
                T=np.linspace(290.0, 240.0, k) * np.ones((n, 1)),
                q_tot=8e-3 + 2e-3 * rng.random((n, k)))
    values = {f: base.get(f, 1e-4 * (1 + rng.random((n, k)))) for f in fields}
    for f in ("n_lcl", "n_rai", "n_ice"):
        if f in values:
            values[f] = values[f] * 1e11
    if "b_rim" in values:
        values["b_rim"] = values["b_rim"] * 1e-3
    return {f: torch.tensor(v, dtype=dtype) for f, v in values.items()}


def _tully(dtype=torch.float32, n=MEMBERS):
    """Tully et al. 2023's cirrus parcel, ``n`` members at updrafts from the
    published 3.5 cm/s to 1 m/s, its vapour raised from 3.3e-4 to 3.5e-4 so
    that the dust nucleates ice from the first step."""
    ic = parcel_ic(20000.0, 230.0, 3.5e-4, 0.0, 0.0, 2e6, 0.0, 0.0,
                   device="cpu", dtype=dtype)
    y = PM.ParcelState(*(v.expand(n).clone() for v in ic))
    w = torch.tensor(np.r_[3.5e-2, np.geomspace(1e-2, 1.0, n - 1)],
                     dtype=dtype)
    params = PM.parcel_params(aerosol=DesertDust(), deposition="MohlerAF",
                              deposition_growth="Deposition", r_nuc=5e-11,
                              const_dt=0.1, w=w)
    return y, params


def _steps():
    """One step of each column module on the CPU (their plain path) and of
    the parcel."""
    st1 = C.ColumnState(**_column_state(C.ColumnState._fields))
    m1 = C.Column1MStep(microphysics_1m_params(), TPS,
                        terminal_velocity_params(), 1.0, 100.0, device="cpu")
    st2 = C.ColumnState2M(**_column_state(C.ColumnState2M._fields))
    m2 = C.Column2MStep(microphysics_2m_params(), TPS, 1.0, 100.0,
                        device="cpu")
    st3 = C.ColumnStateP3(**_column_state(C.ColumnStateP3._fields, n=2,
                                          k=3))
    m3 = C.ColumnP3Step(microphysics_2m_params(with_ice=True,
                                               quadrature_order=4),
                        TPS, 1.0, 100.0, device="cpu")
    y, params = _tully()
    return [lambda: m1(st1), lambda: m1(K1.pack_state(st1)),
            lambda: m2(st2), lambda: m2(K2.pack_state_2m(st2)),
            lambda: m3(st3),
            lambda: PM.parcel_step(params, y, 0.0, torch.zeros(MEMBERS))]


def test_no_profiler_records_nothing_and_calls_no_record_function(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "RECORD", refuse)
    steps = _steps()
    trace.reset()
    assert not trace.recording()
    for step in steps:
        step()
    assert trace.totals() == {}
    assert trace.span("step.anything") is trace.span("launch.k1")


def test_spans_lie_in_the_profiler_trace_nested_and_add_up():
    y, params = _tully()
    model = C.Column1MStep(microphysics_1m_params(), TPS,
                           terminal_velocity_params(), 1.0, 100.0,
                           device="cpu")
    packed = K1.pack_state(C.ColumnState(**_column_state(
        C.ColumnState._fields)))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        dS = torch.zeros(MEMBERS)
        for _ in range(3):
            y, dS = PM.parcel_step(params, y, 0.0, dS)
        model(packed)
    assert not trace.recording()
    totals = trace.totals()
    children = ("parcel.thermo", *FAMILIES, "parcel.update")
    assert set(totals) == {"step.parcel", "step.column1m", *children}
    assert all(totals[n]["count"] == 3 for n in ("step.parcel", *children))
    assert totals["step.column1m"]["count"] == 1
    for t in totals.values():
        assert 0 <= t["self_ns"] <= t["total_ns"]
    # the parent's total is its self time and its children's totals
    parent = totals["step.parcel"]
    assert parent["total_ns"] == parent["self_ns"] + sum(
        totals[n]["total_ns"] for n in children)
    for n in children:
        assert totals[n]["self_ns"] == totals[n]["total_ns"]
    # the same spans in the profiler's own events, each child inside a step
    events = [e for e in prof.events()
              if e.name.startswith(("step.", "parcel."))]
    steps = [e.time_range for e in events if e.name == "step.parcel"]
    assert len(steps) == 3
    for e in events:
        assert e.name in totals
        if e.name.startswith("parcel."):
            assert any(s.start <= e.time_range.start
                       and e.time_range.end <= s.end for s in steps), e.name
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == "step.parcel"
    assert sum(e.name in children for e in events) == 3 * len(children)
    # the disabled families have no span
    assert "parcel.activation" not in totals
    trace.reset()
    assert trace.totals() == {}


def test_a_span_inside_its_own_name_adds_its_total_once():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("step.outer"):
            with trace.span("step.outer"):
                pass
    t = trace.totals()["step.outer"]
    assert t["count"] == 2
    assert t["self_ns"] <= t["total_ns"]
    trace.reset()


def test_counters_count_and_timed_adds_its_seconds():
    name = "test.counter"
    before = trace.counter(name)
    trace.count(name)
    trace.count(name, 4)
    assert trace.counter(name) == before + 5
    assert trace.counter("test.never_counted") == 0
    secs = "test.seconds"
    start = trace.counter(secs)
    trace.add_seconds(secs, 0.25)
    assert trace.counter(secs) == pytest.approx(start + 0.25)

    @trace.timed(secs)
    def sleeps():
        time.sleep(0.01)
        return 3

    start = trace.counter(secs)
    assert sleeps() == 3
    assert trace.counter(secs) - start >= 0.01
    start = trace.counter(secs)
    with trace.timed(secs):
        time.sleep(0.02)
    assert trace.counter(secs) - start >= 0.02


def test_parameter_factories_add_to_setup_seconds():
    name = "setup.params_s"
    for make in (microphysics_1m_params, terminal_velocity_params,
                 lambda: microphysics_2m_params(with_ice=True,
                                                quadrature_order=8),
                 lambda: K1.kernel_params(microphysics_1m_params(), TPS,
                                          terminal_velocity_params()),
                 lambda: K5.kernel_params_p3(microphysics_2m_params(
                     with_ice=True, quadrature_order=4), TPS, device="cpu"),
                 lambda: PM.parcel_params(w=0.5)):
        before = trace.counter(name)
        make()
        assert trace.counter(name) > before


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``nvcc`` stood in for by a script that waits and copies a shared
    library of the interpreter's (ctypes' own) to its output; builds go to
    ``tmp_path``."""
    import _ctypes

    path = _ctypes.__file__
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys, time\n"
        "time.sleep(0.05)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"shutil.copy({path!r}, out)\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_library_builds_loads_and_first_launch_are_counted(fake_nvcc):
    names = ("kernels.builds", "kernels.build_s", "kernels.loads",
             "kernels.load_s")
    before = dict(zip(names, map(trace.counter, names)))
    text = f"// {fake_nvcc}\n"
    trace.reset()
    look_up = (lambda: _build.library(
        "roof.cu", "kernel", text,
        lambda: _build.build("roof.cu", "stand_in.h", text), lambda l: l))
    with profile(activities=[ProfilerActivity.CPU]):
        lib = look_up()
    spans = trace.totals()
    assert spans["kernels.load"]["count"] == spans["kernels.build"]["count"]
    assert (spans["kernels.load"]["total_ns"]
            >= spans["kernels.build"]["total_ns"] >= 0.05e9)
    trace.reset()
    after = dict(zip(names, map(trace.counter, names)))
    assert after["kernels.builds"] == before["kernels.builds"] + 1
    assert after["kernels.loads"] == before["kernels.loads"] + 1
    assert after["kernels.build_s"] - before["kernels.build_s"] >= 0.05
    # the load's seconds leave the build's out
    load_s = after["kernels.load_s"] - before["kernels.load_s"]
    assert 0 <= load_s < 0.05
    assert _build.loads() == after["kernels.loads"]
    # built once: a second look-up returns the library, and a new
    # process's build reuses the file
    assert look_up() is lib
    assert trace.counter("kernels.loads") == after["kernels.loads"]
    _build.build("roof.cu", "stand_in.h", text)
    assert trace.counter("kernels.builds") == after["kernels.builds"]
    # the first launch through the library adds to the load's seconds
    with _build.launching(lib):
        pass
    first = trace.counter("kernels.load_s")
    assert first > after["kernels.load_s"]
    with _build.launching(lib):
        pass
    assert trace.counter("kernels.load_s") == first


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_parcel_step_looped_is_run_parcel_bit_for_bit(dtype):
    y, params = _tully(dtype)
    params = dataclasses.replace(params, w=params.w.to(dtype))
    traj = PM.run_parcel(y, 0.0, 5.0, params)
    dS = torch.zeros_like(y.S_l)
    for i in range(traj.S_l.shape[0] - 1):
        y, dS = PM.parcel_step(params, y, float(i) * 0.1, dS)
        for name, a, b in zip(y._fields, y, traj):
            assert torch.equal(a, b[i + 1]), (name, i)
    assert bool((traj.N_ice[-1] > 0).any())   # the step nucleated ice


class _FakeK3Library:
    """A stand-in for a loaded float32 ``column2m.cu`` build: its entry
    points return success, compute nothing and record each launch's
    ``(ncol, nlev, block_cols)`` in :attr:`plans`."""

    def __init__(self):
        self.plans = []

    def column2m_step_packed(self, *args):
        self.plans.append(args[3:6])
        return 0

    def column2m_step_unpacked(self, *args):
        self.plans.append(args[14:17])
        return 0

    def column2m_threads_per_block(self):
        return 512


@pytest.fixture
def fake_k3(monkeypatch):
    """The 2M wrappers' launch path on CPU tensors: the fields report a
    CUDA device, the library is :class:`_FakeK3Library`, and the stream is
    a null one; returns the library."""
    import types

    lib = _FakeK3Library()
    monkeypatch.setattr(_build, "check_cuda",
                        lambda *a: torch.device("cuda", 0))
    monkeypatch.setattr(K2, "_library", lambda *a, **k: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib


def _spans_2m(prof):
    """The 2M path's spans in the profiler's events: name -> the names of
    the spans each lies in, innermost first."""
    found = {}
    for e in prof.events():
        if not e.name.startswith(("step.", "column.", "column2m.",
                                  "launch.")):
            continue
        parents, p = [], e.cpu_parent
        while p is not None:
            parents.append(p.name)
            p = p.cpu_parent
        found.setdefault(e.name, []).append(parents)
    return found


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_2m_fields_path_spans_and_packed_bytes_on_the_cpu(dtype):
    """The fields path of ``step_column_2m(impl="fused")`` on the CPU (the
    wrappers' plain path): ``step.column2m`` holds no span (no packing, no
    launch), the fields are stacked nowhere, so no ``column2m.packed_bytes``
    is counted; with no profiler nothing is recorded; the results are the
    eager step's, bit for bit."""
    n, k = 8, 6
    st = C.ColumnState2M(**_column_state(C.ColumnState2M._fields, n, k,
                                         dtype))
    mp = microphysics_2m_params()
    trace.reset()
    out = C.step_column_2m(st, mp, TPS, 1.0, 100.0, impl="fused")
    assert trace.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            again = C.step_column_2m(st, mp, TPS, 1.0, 100.0, impl="fused")
    totals = trace.totals()
    assert set(totals) == {"step.column2m"}
    assert totals["step.column2m"]["count"] == 3
    assert (totals["step.column2m"]["total_ns"]
            == totals["step.column2m"]["self_ns"])
    assert set(_spans_2m(prof)) == {"step.column2m"}
    assert trace.counter("column2m.packed_bytes") == 0
    # the spans change no bit: the eager step gives the same fields
    eager = C.step_column_2m(st, mp, TPS, 1.0, 100.0)
    for a, b, c in zip(out, again, eager):
        assert torch.equal(a, b) and torch.equal(a, c)
    trace.reset()


def test_2m_launch_spans_nest_in_the_step_span(fake_k3):
    """On the launch path (a stand-in library on CPU tensors), under the
    profiler: the fields path of ``step_column_2m(impl="fused")`` and
    ``Column2MStep`` on the fields are ``step.column2m`` ⊃
    ``column.prepare``, ``launch.k4``, and ``Column2MStep`` on the packed
    state ``step.column2m`` ⊃ ``column.prepare``, ``launch.k3``; each
    launch counted under its wrapper, and its launch plan (K4's on the
    fields and K3's on the packed state alike) added to ``k3.lane_slots``
    and ``k3.cells``; without the profiler no span is recorded."""
    n, k = 16, 5
    st = C.ColumnState2M(**_column_state(C.ColumnState2M._fields, n, k))
    mp = microphysics_2m_params()
    model = C.Column2MStep(mp, TPS, 1.0, 100.0, device="cpu")
    packed = K2.pack_state_2m(st)
    cases = [
        (lambda: C.step_column_2m(st, mp, TPS, 1.0, 100.0, impl="fused"),
         {"column.prepare": 1, "launch.k4": 1}, "step_column_2m_fused"),
        (lambda: model(packed), {"column.prepare": 1, "launch.k3": 1},
         "step_column_2m_fused_packed"),
        (lambda: model(st), {"column.prepare": 1, "launch.k4": 1},
         "step_column_2m_fused"),
    ]
    for fn, inner, wrapper in cases:
        launches = {w: trace.counter(f"launches.{w}")
                    for w in ("step_column_2m_fused",
                              "step_column_2m_fused_packed")}
        plan = [trace.counter(c) for c in ("k3.lane_slots", "k3.cells")]
        fake_k3.plans.clear()
        trace.reset()
        fn()
        assert trace.totals() == {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                fn()
        totals = trace.totals()
        assert set(totals) == {"step.column2m", *inner}
        assert totals["step.column2m"]["count"] == 2
        for name, per_call in inner.items():
            assert totals[name]["count"] == 2 * per_call, name
        step = totals["step.column2m"]
        assert step["total_ns"] == step["self_ns"] + sum(
            totals[name]["total_ns"] for name in inner)
        spans = _spans_2m(prof)
        for name in inner:
            for parents in spans[name]:
                assert parents[0] == "step.column2m", (name, parents)
        for w, before in launches.items():
            assert (trace.counter(f"launches.{w}")
                    == before + 3 * (w == wrapper)), w
        # 16 columns of 5 levels at 16 a block: a column a warp, each in
        # one window of 32 slots
        assert fake_k3.plans == 3 * [(n, k, 16)]
        assert K2.lane_slots(n, k, 16, 16) == n * 32
        assert [trace.counter(c) - b for c, b in
                zip(("k3.lane_slots", "k3.cells"), plan)] == [
            3 * K2.lane_slots(n, k, 16, 16), 3 * n * k]
    assert trace.counter("column2m.packed_bytes") == 0
    trace.reset()
