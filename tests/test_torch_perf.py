"""The port's performance harness (cloudmicrophysics_tpu_torch/perf.py)
against the JAX package's (cloudmicrophysics_tpu/perf.py), on the CPU.

``chunked_cells`` of a column step is the flat step bit for bit (each
column is computed by the same code whatever chunk holds it), and equals
the JAX package's ``chunked_cells`` at float64 to rtol 1e-9 with an
absolute floor of 1e-12 of the largest value (torch and XLA:CPU
exp/log/pow differ by a few ULP), the tolerance of the column-step parity
tests.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu import perf as JPERF
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch import perf
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.models import column as TC

MS = 1e6  # ns per ms


def _f32(n=64):
    return torch.linspace(0.1, 1.0, n, dtype=torch.float32)


def test_same_names_as_the_jax_harness():
    assert perf.__all__ == JPERF.__all__
    assert perf.BenchReport._fields == JPERF.BenchReport._fields


def test_report_and_single_build_on_a_repeat_call():
    r = perf.bench_press(torch.exp, (_f32(),), 1000 * MS)
    assert r.n_traces == 1 and r.ok
    assert r.name == "exp" and r.budget_ns == 1000 * MS
    assert 0 < r.best_ns <= r.budget_ns


def test_raises_on_a_breached_budget():
    with pytest.raises(AssertionError, match="over budget"):
        perf.bench_press(lambda x: torch.exp(x) + 1.0, (_f32(4096),), 0.0,
                         name="exp_plus_one")


def test_raises_on_float64_promotion():
    with pytest.raises(AssertionError, match="promoted"):
        perf.bench_press(lambda x: x.double() * 2.0, (_f32(),), 1000 * MS,
                         name="promote")
    # no check, no error; and an integer output is no promotion
    perf.bench_press(lambda x: x.double(), (_f32(),), 1000 * MS,
                     check_dtype=False)
    perf.bench_press(lambda x: (x > 0.5).long(), (_f32(),), 1000 * MS)


def test_raises_when_a_repeat_call_loads_a_library(monkeypatch, tmp_path):
    """A function whose second call builds and loads another kernel
    library (here the C library, standing in for an nvcc build) breaks the
    zero-build gate."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a kernel library")
    monkeypatch.setattr(_build, "build", lambda *a, **k: libc)
    calls = []

    def fn(x):
        calls.append(1)
        _build.load("stand_in.cu", "stand_in.h", f"// call {len(calls)} "
                    f"{tmp_path}\n")
        return x * 2.0

    with pytest.raises(AssertionError, match="loaded 1 kernel libraries"):
        perf.bench_press(fn, (_f32(),), 1000 * MS, name="rebuilds")
    assert len(calls) == 2


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with perf.profile_trace(str(log_dir)):
        torch.exp(_f32(1024)).sum()
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("exp" in e.get("name", "") for e in events)


def _column_arrays(ncol, nlev, seed=3):
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    return dict(
        rho=np.linspace(1.2, 0.4, nlev)[None, :] * ones,
        T=np.linspace(300.0, 230.0, nlev)[None, :] * ones,
        q_tot=1e-2 * rng.random(shape), q_lcl=1e-3 * rng.random(shape),
        q_icl=5e-4 * rng.random(shape), q_rai=5e-4 * rng.random(shape),
        q_sno=5e-4 * rng.random(shape))


MP_J = JP.microphysics_1m_params()
MP_T = TP.from_tree(TP.Microphysics1MParams, dataclasses.asdict(MP_J))
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
TV_J, TV_T = JP.terminal_velocity_params(), TP.terminal_velocity_params()


def _step_t(state):
    return TC.step_column_1m(state, MP_T, TPS_T, TV_T, 1.0, 100.0)


def _step_j(state):
    return JC.step_column_1m(state, MP_J, TPS_J, TV_J, 1.0, 100.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunked_cells_is_the_flat_column_step(dtype):
    st = TP.column_state_from_numpy(_column_arrays(8, 16), device="cpu",
                                    dtype=dtype)
    flat = _step_t(st)
    chunked = perf.chunked_cells(_step_t, 4)(st)
    assert type(chunked) is type(flat)
    for name, a, b in zip(flat._fields, flat, chunked):
        assert torch.equal(a, b), name


def test_chunked_cells_matches_the_jax_package():
    arrays = _column_arrays(8, 16)
    st_t = TP.column_state_from_numpy(arrays, device="cpu",
                                      dtype=torch.float64)
    st_j = JC.ColumnState(*(jnp.asarray(arrays[k], jnp.float64)
                            for k in JC.ColumnState._fields))
    got = perf.chunked_cells(_step_t, 4)(st_t)
    want = jax.jit(JPERF.chunked_cells(_step_j, 4))(st_j)
    for name, a, b in zip(want._fields, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)


def test_chunked_cells_passes_other_leaves_and_joins_nested_results():
    def fn(a, pair, scale, none):
        assert none is None and scale == 3.0
        return {"sum": a + pair[0], "rows": (pair[1] * scale,)}

    a = torch.arange(12.0).reshape(6, 2)
    pair = (torch.ones(6, 2), torch.arange(6.0))
    out = perf.chunked_cells(fn, 3)(a, pair, 3.0, None)
    assert torch.equal(out["sum"], a + 1.0)
    assert torch.equal(out["rows"][0], torch.arange(6.0) * 3.0)


def test_chunked_cells_rejects_a_leaf_that_does_not_divide():
    st = TP.column_state_from_numpy(_column_arrays(6, 4), device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        perf.chunked_cells(_step_t, 4)(st)
    with pytest.raises(ValueError, match="do not divide"):
        perf.chunked_cells(lambda x: x, 2)(torch.tensor(1.0))
    with pytest.raises(ValueError, match="n_chunks"):
        perf.chunked_cells(_step_t, 0)
