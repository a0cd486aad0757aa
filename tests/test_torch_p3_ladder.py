"""The 2M + P3 tendencies of the port on the 10 curated column states of
tests/test_quadrature_ladder.py, against the JAX package, and the
device-accuracy record kept in the port package.

* ``bulk_tendencies_2m`` with ``mp.ice`` set (``ice_tendencies_2m_p3``), the
  shape solve feeding it as in the ladder test, at GL-8 and GL-16, float64:
  rtol 1e-9 with an absolute floor of 1e-12 of each component's largest
  magnitude over the states.
* ``cloudmicrophysics_tpu_torch/data/p3_ladder_gl16.json`` holds the JAX
  package's float64 ``step_column_p3`` (GL-16, one step, dt = 1 s,
  dz = 100 m) on those states, each a one-level column. chip_smoke.py holds
  the CUDA kernel's float32 step to it. The test regenerates it from JAX and
  fails if the file is stale; ``python tests/test_torch_p3_ladder.py``
  rewrites it.
"""

import dataclasses
import json
import sys
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
from cloudmicrophysics_tpu.models.tendencies import bulk_tendencies_2m as JB
from cloudmicrophysics_tpu.ops import p3 as JP3
from cloudmicrophysics_tpu_torch.models import column as TC
from cloudmicrophysics_tpu_torch.models.tendencies import bulk_tendencies_2m as TB
from cloudmicrophysics_tpu_torch.ops import p3 as TP3

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_quadrature_ladder import STATES  # noqa: E402

TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
RTOL, ATOL_REL = 1e-9, 1e-12
RECORD = (Path(cloudmicrophysics_tpu_torch.__file__).resolve().parent
          / "data" / "p3_ladder_gl16.json")
FIELDS = JC.ColumnStateP3._fields


def _columns():
    arr = np.asarray(STATES, dtype=np.float64)
    return arr.T   # (11 fields, 10 states)


def _jax_rates(mp, cols):
    def rates(c):
        rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, \
            b_rim = c
        ps = JP3.state_from_prognostic(mp.ice.scheme, q_ice * rho,
                                       n_ice * rho, q_rim * rho, b_rim * rho)
        ll = JP3.get_distribution_loglambda(ps)
        return JB(mp, TPS_J, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
                  q_ice, n_ice, q_rim, b_rim, ll)

    return jax.jit(rates)(tuple(jnp.asarray(c) for c in cols))


def _torch_rates(mp, cols):
    rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, b_rim = (
        torch.tensor(c) for c in cols)
    ps = TP3.state_from_prognostic(mp.ice.scheme, q_ice * rho, n_ice * rho,
                                   q_rim * rho, b_rim * rho)
    ll = TP3.get_distribution_loglambda(ps)
    return TB(mp, TPS_T, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice,
              n_ice, q_rim, b_rim, ll)


@pytest.mark.parametrize("order", [8, 16])
def test_ladder_tendencies_match_jax(order):
    mp_j = JP.microphysics_2m_params(with_ice=True, quadrature_order=order)
    mp_t = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(mp_j))
    cols = _columns()
    ref = _jax_rates(mp_j, cols)
    out = _torch_rates(mp_t, cols)
    assert type(out).__name__ == "Tendencies2M"
    for name, a, b in zip(ref._fields, out, ref):
        b = np.asarray(b)
        assert np.isfinite(b).all() and torch.isfinite(a).all(), name
        atol = ATOL_REL * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=f"GL-{order}: {name}")
    # the rain-only state (index 2) has no ice: finite, zero ice tendencies
    for name in ("dq_ice_dt", "dn_ice_dt", "dq_rim_dt", "db_rim_dt"):
        assert getattr(out, name)[2] == 0, name


def _record():
    """The JAX float64 GL-16 step on the ladder states (one-level columns)."""
    mp = JP.microphysics_2m_params(with_ice=True, quadrature_order=16)
    cols = _columns()
    st = JC.ColumnStateP3(*(jnp.asarray(c[:, None]) for c in cols))
    new, ll = jax.jit(lambda s: JC.step_column_p3(s, mp, TPS_J, 1.0, 100.0)
                      )(st)
    return {
        "what": "JAX float64 step_column_p3, GL-16, one step, dt = 1 s, "
                "dz = 100 m, on the 10 curated states of "
                "tests/test_quadrature_ladder.py, each a one-level column",
        "quadrature_order": 16, "dt": 1.0, "dz": 100.0,
        "fields": list(FIELDS),
        "states": [list(map(float, row)) for row in STATES],
        "step": {f: [float(v) for v in np.asarray(x)[:, 0]]
                 for f, x in zip(FIELDS, new)},
        "loglambda": [float(v) for v in np.asarray(ll)[:, 0]],
    }


def test_device_accuracy_record_is_current():
    stored = json.loads(RECORD.read_text())
    fresh = _record()
    assert stored["states"] == fresh["states"]
    assert stored["fields"] == fresh["fields"]
    for key in ("quadrature_order", "dt", "dz"):
        assert stored[key] == fresh[key], key
    for f in FIELDS:
        np.testing.assert_allclose(stored["step"][f], fresh["step"][f],
                                   rtol=1e-13, atol=0, err_msg=f)
    np.testing.assert_allclose(stored["loglambda"], fresh["loglambda"],
                               rtol=1e-13, atol=0)


def test_port_float64_step_matches_the_record():
    stored = json.loads(RECORD.read_text())
    mp = TP.microphysics_2m_params(with_ice=True, quadrature_order=16)
    cols = np.asarray(stored["states"], dtype=np.float64).T
    st = TC.ColumnStateP3(*(torch.tensor(c[:, None]) for c in cols))
    new, ll = TC.step_column_p3(st, mp, TPS_T, stored["dt"], stored["dz"])
    for f, x in zip(FIELDS, new):
        want = np.asarray(stored["step"][f])
        atol = ATOL_REL * float(np.max(np.abs(want)))
        np.testing.assert_allclose(x[:, 0].numpy(), want, rtol=RTOL,
                                   atol=atol, err_msg=f)
    want = np.asarray(stored["loglambda"])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(ll[:, 0].numpy()), fin)
    np.testing.assert_allclose(ll[:, 0].numpy()[fin], want[fin], rtol=RTOL)


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(_record(), indent=1) + "\n")
    print(f"wrote {RECORD}")
