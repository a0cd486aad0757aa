"""Device-accuracy records of the 1M and 2M column steps, kept in the port
package (``cloudmicrophysics_tpu_torch/data/column_records_f64.json``).

* The record holds the JAX package's float64 ``step_column_1m``
  (instantaneous, and linearized_average with 4 substeps of a 10 s step)
  and ``step_column_2m``, three steps each, on a few fixed columns, with
  the JAX package's own float32 step's error against each (x64 off, as on
  a TPU): per field, the largest absolute difference over the field's
  largest magnitude. chip_smoke.py holds the float64 K1 and K3 to the
  record and prints the float32 kernels' error beside JAX's.
* The test regenerates the record from JAX and fails if the file is stale;
  ``python tests/test_torch_column_records.py`` rewrites it.
* The port's float64 eager steps match the record (rtol 1e-9 with an
  absolute floor of 1e-12 of the field's largest magnitude), and its
  float32 eager steps err as JAX's float32 steps do: per field, at most
  twice JAX's error plus 1e-6.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch.models import column as TC

RECORD = (Path(cloudmicrophysics_tpu_torch.__file__).resolve().parent
          / "data" / "column_records_f64.json")
RTOL, ATOL_REL = 1e-9, 1e-12
NCOL, NLEV, STEPS, DZ, SEED = 4, 24, 3, 100.0, 11
# name -> (scheme, step keywords)
CASES = {
    "1m_instantaneous": ("1m", dict(dt=1.0, mode="instantaneous", nsub=1)),
    "1m_linearized_average": ("1m", dict(dt=10.0, mode="linearized_average",
                                         nsub=4)),
    "2m": ("2m", dict(dt=1.0)),
}


def _columns(scheme):
    """The record's columns in numpy float64: rho and T profiles over the
    levels (T from 300 K down to 225 K, across freezing), seeded contents."""
    rng = np.random.default_rng(SEED)
    shape = (NCOL, NLEV)
    ones = np.ones((NCOL, 1))
    a = dict(rho=np.linspace(1.2, 0.4, NLEV)[None, :] * ones,
             T=np.linspace(300.0, 225.0, NLEV)[None, :] * ones,
             q_tot=1e-2 * rng.random(shape), q_lcl=1e-3 * rng.random(shape))
    if scheme == "1m":
        a.update(q_icl=5e-4 * rng.random(shape), q_rai=5e-4 * rng.random(shape),
                 q_sno=5e-4 * rng.random(shape))
        return a
    a.update(n_lcl=1e8 * rng.random(shape), q_rai=5e-4 * rng.random(shape),
             n_rai=1e6 * rng.random(shape))
    return a


def _jax_steps(scheme, kw, arrays, dtype):
    """``STEPS`` JAX steps of ``arrays`` at ``dtype``; numpy float64 out."""
    if scheme == "1m":
        mp, tv = JP.microphysics_1m_params(), JP.terminal_velocity_params()
        st = JC.ColumnState(*(jnp.asarray(arrays[k], dtype)
                              for k in JC.ColumnState._fields))

        def step(s):
            return JC.step_column_1m(s, mp, JP.ThermodynamicsParameters(),
                                     tv, kw["dt"], DZ, mode=kw["mode"],
                                     nsub=kw["nsub"])
    else:
        mp = JP.microphysics_2m_params()
        st = JC.ColumnState2M(*(jnp.asarray(arrays[k], dtype)
                                for k in JC.ColumnState2M._fields))

        def step(s):
            return JC.step_column_2m(s, mp, JP.ThermodynamicsParameters(),
                                     kw["dt"], DZ)
    step = jax.jit(step)
    for _ in range(STEPS):
        st = step(st)
    assert st.T.dtype == dtype
    return {f: np.asarray(x, np.float64) for f, x in zip(st._fields, st)}


def _errors(got, want):
    """Per field, the largest absolute difference over the field's largest
    magnitude."""
    return {f: float(np.max(np.abs(got[f] - w)) / max(np.max(np.abs(w)),
                                                      1e-300))
            for f, w in want.items()}


def _record():
    out = {"what": "JAX float64 step_column_1m / step_column_2m, "
                   f"{STEPS} steps, dz = {DZ} m, on {NCOL} columns of "
                   f"{NLEV} levels (seed {SEED}); jax_float32_error: the "
                   "JAX float32 step's (x64 off) largest absolute "
                   "difference per field over the field's largest "
                   "magnitude",
           "steps": STEPS, "dz": DZ, "cases": {}}
    for name, (scheme, kw) in CASES.items():
        arrays = _columns(scheme)
        ref = _jax_steps(scheme, kw, arrays, jnp.float64)
        with jax.enable_x64(False):
            f32 = _jax_steps(scheme, kw, arrays, jnp.float32)
        out["cases"][name] = {
            "scheme": scheme, **kw,
            "state": {f: v.tolist() for f, v in arrays.items()},
            "step": {f: v.tolist() for f, v in ref.items()},
            "jax_float32_error": _errors(f32, ref)}
    return out


@pytest.fixture(scope="module")
def stored():
    return json.loads(RECORD.read_text())


def test_record_is_current(stored):
    fresh = _record()
    assert stored["steps"] == fresh["steps"] and stored["dz"] == fresh["dz"]
    assert set(stored["cases"]) == set(fresh["cases"])
    for name, case in fresh["cases"].items():
        old = stored["cases"][name]
        for key in ("scheme", "dt", "mode", "nsub"):
            assert old.get(key) == case.get(key), (name, key)
        assert old["state"] == case["state"], name
        for f, v in case["step"].items():
            np.testing.assert_allclose(old["step"][f], v, rtol=1e-13, atol=0,
                                       err_msg=f"{name}: {f}")
        for f, e in case["jax_float32_error"].items():
            np.testing.assert_allclose(old["jax_float32_error"][f], e,
                                       rtol=1e-6, err_msg=f"{name}: {f}")


def _torch_steps(case, dtype):
    """``STEPS`` eager port steps of the record's state at ``dtype``."""
    if case["scheme"] == "1m":
        st = TP.column_state_from_numpy(
            {f: np.asarray(v) for f, v in case["state"].items()},
            device="cpu", dtype=dtype)
        mp, tv = TP.microphysics_1m_params(), TP.terminal_velocity_params()
        for _ in range(STEPS):
            st = TC.step_column_1m(st, mp, TP.ThermodynamicsParameters(), tv,
                                   case["dt"], DZ, mode=case["mode"],
                                   nsub=case["nsub"])
    else:
        st = TP.column_state_2m_from_numpy(
            {f: np.asarray(v) for f, v in case["state"].items()},
            device="cpu", dtype=dtype)
        mp = TP.microphysics_2m_params()
        for _ in range(STEPS):
            st = TC.step_column_2m(st, mp, TP.ThermodynamicsParameters(),
                                   case["dt"], DZ)
    assert st.T.dtype == dtype
    return {f: x.numpy().astype(np.float64) for f, x in zip(st._fields, st)}


@pytest.mark.parametrize("name", list(CASES))
def test_port_float64_steps_match_the_record(stored, name):
    case = stored["cases"][name]
    out = _torch_steps(case, torch.float64)
    for f, want in case["step"].items():
        want = np.asarray(want)
        atol = ATOL_REL * float(np.max(np.abs(want)))
        np.testing.assert_allclose(out[f], want, rtol=RTOL, atol=atol,
                                   err_msg=f"{name}: {f}")


@pytest.mark.parametrize("name", list(CASES))
def test_port_float32_steps_err_as_the_jax_float32_steps(stored, name):
    case = stored["cases"][name]
    want = {f: np.asarray(v) for f, v in case["step"].items()}
    port = _errors(_torch_steps(case, torch.float32), want)
    for f, e in port.items():
        jax_e = case["jax_float32_error"][f]
        assert e <= 2 * jax_e + 1e-6, (name, f, e, jax_e)
    # the float32 step is not exact: the comparison has something to hold
    assert max(port.values()) > 1e-7


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(_record(), indent=1) + "\n")
    print(f"wrote {RECORD}")
