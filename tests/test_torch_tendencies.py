"""Float64 parity of the port's fused 0M/1M/2M tendencies and the scheme
dispatcher with the JAX package.

Tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest
reference value, as in test_torch_ops_1m.py. The linearized implicit
substeps divide by donor contents and solve 2x2 blocks, which can lift
ULP-level differences of small terms, but stay far inside that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import tendencies as JT
from cloudmicrophysics_tpu_torch.models import tendencies as TT

RTOL, ATOL_REL = 1e-9, 1e-12
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
FIELDS = ("rho", "T", "q_tot", "q_lcl", "q_icl", "q_rai", "q_sno")


def _state(n=80, seed=5):
    rng = np.random.default_rng(seed)
    s = dict(rho=rng.uniform(0.5, 1.3, n), T=rng.uniform(230.0, 300.0, n),
             q_tot=rng.uniform(2e-3, 2e-2, n))
    for name, scale in (("q_lcl", 2e-3), ("q_icl", 1e-3), ("q_rai", 2e-3),
                        ("q_sno", 1e-3)):
        v = rng.uniform(0.0, scale, n)
        v[rng.random(n) < 0.15] = 0.0
        s[name] = v
    s["T"][:3] = [TPS_J.T_freeze, TPS_J.T_freeze + 3.0, TPS_J.T_freeze - 3.0]
    return s


S = _state()


def _args(to_array):
    return [to_array(S[k]) for k in FIELDS]


def _assert_close(out, ref, what):
    for i, (a, b) in enumerate(zip(out, ref)):
        b = np.asarray(b, np.float64)
        atol = ATOL_REL * max(float(np.max(np.abs(b), initial=0.0)), 1e-300)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=f"{what}[{i}]")


def _mps(**options):
    mp_j = JP.microphysics_1m_params(**options)
    return mp_j, TP.from_tree(TP.Microphysics1MParams,
                              dataclasses.asdict(mp_j))


J_ARGS = _args(lambda x: jnp.asarray(x, jnp.float64))
T_ARGS = _args(lambda x: torch.as_tensor(x, dtype=torch.float64))


@pytest.mark.parametrize("options", [
    {}, {"rain_autoconversion": "PrescribedNd"},
    {"snow_autoconversion": "WithSupersaturation"},
    {"cloud_ice_formation": "TemperatureDependent"},
    {"snow_deposition_sublimation": "SublimationOnly", "snow_melt": None},
])
def test_instantaneous(options):
    mp_j, mp_t = _mps(**options)
    ref = JT.bulk_tendencies_1m(mp_j, TPS_J, *J_ARGS)
    out = TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS)
    assert type(out).__name__ == "Tendencies1M"
    _assert_close(out, ref, "instantaneous")


def test_instantaneous_verbose_source_terms():
    mp_j, mp_t = _mps()
    ref_t, ref_s = JT.bulk_tendencies_1m(mp_j, TPS_J, *J_ARGS,
                                         mode="instantaneous_verbose")
    out_t, out_s = TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS,
                                         mode="instantaneous_verbose")
    assert out_s._fields == ref_s._fields
    _assert_close(out_t, ref_t, "tendencies")
    _assert_close(out_s, ref_s, "source terms")


@pytest.mark.parametrize("nsub", [1, 4])
@pytest.mark.parametrize("dt", [10.0, 100.0])
def test_linearized_average(nsub, dt):
    mp_j, mp_t = _mps()
    ref = JT.bulk_tendencies_1m(mp_j, TPS_J, *J_ARGS,
                                mode="linearized_average", dt=dt, nsub=nsub)
    out = TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS,
                                mode="linearized_average", dt=dt, nsub=nsub)
    _assert_close(out, ref, f"linearized_average nsub={nsub} dt={dt}")


def test_linearized_average_with_options():
    mp_j, mp_t = _mps(cloud_ice_formation="TemperatureDependent",
                      rain_autoconversion="PrescribedNd")
    ref = JT.bulk_tendencies_1m(mp_j, TPS_J, *J_ARGS,
                                mode="linearized_average", dt=30.0, nsub=2)
    out = TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS,
                                mode="linearized_average", dt=30.0, nsub=2)
    _assert_close(out, ref, "linearized_average with options")


def test_mode_errors():
    mp_t = _mps()[1]
    with pytest.raises(ValueError, match="unknown tendency mode"):
        TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS, mode="nope")
    with pytest.raises(ValueError, match="requires dt"):
        TT.bulk_tendencies_1m(mp_t, TPS_T, *T_ARGS,
                              mode="linearized_average")


@pytest.mark.parametrize("with_qsat", [False, True])
def test_bulk_tendencies_0m(with_qsat):
    mp_j = JP.microphysics_0m_params(qc_0=2e-4, tau_precip=800.0)
    mp_t = TP.from_tree(TP.Microphysics0MParams, dataclasses.asdict(mp_j))
    j = {k: jnp.asarray(S[k] - 2e-4, jnp.float64)
         for k in ("q_lcl", "q_icl")}
    t = {k: torch.as_tensor(S[k] - 2e-4, dtype=torch.float64)
         for k in ("q_lcl", "q_icl")}
    qsat_j = jnp.asarray(0.5 * S["q_tot"]) if with_qsat else None
    qsat_t = torch.as_tensor(0.5 * S["q_tot"]) if with_qsat else None
    ref = JT.bulk_tendencies_0m(mp_j, TPS_J, jnp.asarray(S["T"]),
                                j["q_lcl"], j["q_icl"], qsat_j)
    out = TT.bulk_tendencies_0m(mp_t, TPS_T, torch.as_tensor(S["T"]),
                                t["q_lcl"], t["q_icl"], qsat_t)
    _assert_close([out], [ref], "0m")


# ---------------------------------------------------------------------------
# 2M warm rain (SB2006) and the scheme dispatcher
# ---------------------------------------------------------------------------

def _state_2m(n=80, seed=9):
    """Random cells with zero, tiny and negative contents and numbers, and
    mean masses beyond the SB2006 limits."""
    rng = np.random.default_rng(seed)
    s = dict(rho=rng.uniform(0.5, 1.3, n), T=rng.uniform(255.0, 305.0, n),
             q_tot=rng.uniform(2e-3, 2e-2, n),
             q_lcl=rng.uniform(0.0, 2e-3, n), q_rai=rng.uniform(0.0, 2e-3, n),
             n_lcl=10 ** rng.uniform(5.0, 9.5, n),
             n_rai=10 ** rng.uniform(0.0, 7.0, n))
    for name in ("q_lcl", "q_rai", "n_lcl", "n_rai"):
        s[name][rng.random(n) < 0.12] = 0.0
        s[name][rng.random(n) < 0.05] = -1e-7 * s[name].max()
    return s


S2 = _state_2m()
FIELDS_2M = ("rho", "T", "q_tot", "q_lcl", "n_lcl", "q_rai", "n_rai")
J2 = [jnp.asarray(S2[k]) for k in FIELDS_2M]
T2 = [torch.as_tensor(S2[k]) for k in FIELDS_2M]


def _mps_2m(**options):
    mp_j = JP.microphysics_2m_params(**options)
    return mp_j, TP.from_tree(TP.Microphysics2MParams,
                              dataclasses.asdict(mp_j))


@pytest.mark.parametrize("is_limited", [True, False])
def test_bulk_tendencies_2m(is_limited):
    mp_j, mp_t = _mps_2m(is_limited=is_limited)
    ref = JT.bulk_tendencies_2m(mp_j, TPS_J, *J2)
    out = TT.bulk_tendencies_2m(mp_t, TPS_T, *T2)
    assert type(out).__name__ == "Tendencies2M"
    assert out._fields == ref._fields
    _assert_close(out, ref, f"bulk_tendencies_2m is_limited={is_limited}")


def test_warm_rain_tendencies_2m():
    mp_j, mp_t = _mps_2m()
    rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai = (np.abs(S2[k]) for k in
                                                 FIELDS_2M)
    q_ice = np.zeros_like(rho)
    args = (T, q_tot, q_lcl, q_rai, q_ice, rho, n_lcl, n_rai)
    ref = JT.warm_rain_tendencies_2m(mp_j.warm_rain, TPS_J,
                                     *(jnp.asarray(a) for a in args))
    out = TT.warm_rain_tendencies_2m(mp_t.warm_rain, TPS_T,
                                     *(torch.as_tensor(a) for a in args))
    _assert_close(out, ref, "warm_rain_tendencies_2m")


def test_dispatcher_matches_each_scheme():
    mp_j, mp_t = _mps_2m(rain_velocity="chen2022")
    _assert_close(TT.bulk_microphysics_tendencies(mp_t, TPS_T, *T2),
                  JT.bulk_microphysics_tendencies(mp_j, TPS_J, *J2), "2M")
    mp_j, mp_t = _mps()
    _assert_close(TT.bulk_microphysics_tendencies(mp_t, TPS_T, *T_ARGS),
                  JT.bulk_microphysics_tendencies(mp_j, TPS_J, *J_ARGS), "1M")
    mp0_j = JP.microphysics_0m_params()
    mp0_t = TP.from_tree(TP.Microphysics0MParams, dataclasses.asdict(mp0_j))
    ref = JT.bulk_microphysics_tendencies(mp0_j, TPS_J, jnp.asarray(S["T"]),
                                          jnp.asarray(S["q_lcl"]),
                                          jnp.asarray(S["q_icl"]))
    out = TT.bulk_microphysics_tendencies(mp0_t, TPS_T,
                                          torch.as_tensor(S["T"]),
                                          torch.as_tensor(S["q_lcl"]),
                                          torch.as_tensor(S["q_icl"]))
    _assert_close([out], [ref], "0M")
    with pytest.raises(TypeError, match="no microphysics scheme"):
        TT.bulk_microphysics_tendencies(TPS_T, TPS_T, *T2)


def test_bulk_tendencies_2m_with_ice_raises():
    # P3 ice is ported: with mp.ice set the 2M tendencies add the P3 ice
    # processes instead of raising. Without ice arguments only nucleation
    # and freezing act; tests/test_torch_p3_ladder.py covers icy states.
    mp_j = JP.microphysics_2m_params(with_ice=True, quadrature_order=4)
    mp_t = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(mp_j))
    ref = jax.jit(lambda *a: JT.bulk_tendencies_2m(mp_j, TPS_J, *a))(*J2)
    out = TT.bulk_tendencies_2m(mp_t, TPS_T, *T2)
    _assert_close(out, ref, "bulk_tendencies_2m with mp.ice")
