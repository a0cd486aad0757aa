"""The port's cloud diagnostics (radar reflectivity 1M/2M, effective
radius 2M, Liu-Hallett, constant) against the JAX package at float64,
rtol 1e-9, on seeded NumPy states that include empty cloud and rain
cells (where the moments take their guarded branch)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.ops import diagnostics as JD
from cloudmicrophysics_tpu_torch.ops import diagnostics as TD

RTOL = 1e-9
MP1_J = JP.microphysics_1m_params()
MP1_T = TP.from_tree(TP.Microphysics1MParams, dataclasses.asdict(MP1_J))
SB_J = JP.microphysics_2m_params().warm_rain.seifert_beheng
SB_T = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(
    JP.microphysics_2m_params())).warm_rain.seifert_beheng


def _state(n=50, seed=8):
    rng = np.random.default_rng(seed)
    q_lcl = np.where(rng.random(n) < 0.8, 10 ** rng.uniform(-7, -2.5, n), 0)
    q_rai = np.where(rng.random(n) < 0.7, 10 ** rng.uniform(-8, -2.5, n), 0)
    return dict(
        rho=rng.uniform(0.4, 1.3, n), q_lcl=q_lcl, q_rai=q_rai,
        N_lcl=np.where(q_lcl > 0, 10 ** rng.uniform(6, 9, n), 0),
        N_rai=np.where(q_rai > 0, 10 ** rng.uniform(2, 6, n), 0))


def _diags(D, mp1, sb, wrap):
    x = {k: wrap(v) for k, v in _state().items()}
    args = (x["q_lcl"], x["q_rai"], x["N_lcl"], x["N_rai"], x["rho"])
    return {
        "radar_reflectivity_1m": D.radar_reflectivity_1m(
            mp1.precip.rain, x["q_rai"], x["rho"]),
        "radar_reflectivity_2m": D.radar_reflectivity_2m(sb, *args),
        "effective_radius_2m": D.effective_radius_2m(sb, *args),
        "liu_hallet_97": D.effective_radius_liu_hallet_97(
            1000.0, x["rho"], x["q_lcl"], x["N_lcl"], x["q_rai"],
            x["N_rai"]),
        "liu_hallet_97_defaults": D.effective_radius_liu_hallet_97(
            1000.0, x["rho"], x["q_lcl"]),
    }


KEYS = sorted(_diags(TD, MP1_T, SB_T, torch.tensor))


@pytest.fixture(scope="module")
def diags():
    return (_diags(TD, MP1_T, SB_T, torch.tensor),
            _diags(JD, MP1_J, SB_J, jnp.asarray))


@pytest.mark.parametrize("key", KEYS)
def test_diagnostic_matches_jax(diags, key):
    got, want = diags
    g, w = got[key].numpy(), np.asarray(want[key])
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-300, err_msg=key)


def test_empty_cells_take_the_floor_and_zero(diags):
    got, _ = diags
    s = _state()
    empty = (s["q_lcl"] == 0) & (s["q_rai"] == 0)
    assert empty.any()
    assert (got["effective_radius_2m"].numpy()[empty] == 0).all()
    assert (got["radar_reflectivity_2m"].numpy()[empty] == -150).all()


def test_effective_radius_const():
    assert TD.effective_radius_const(MP1_T.cloud.liquid) \
        == JD.effective_radius_const(MP1_J.cloud.liquid)
    assert TD.effective_radius_const(MP1_T.cloud.ice) \
        == JD.effective_radius_const(MP1_J.cloud.ice)
