"""Float64 parity of the port's ops/m2 (SB2006 2-moment warm rain and the
legacy fits) with the JAX package, on the same numpy-built states.

The states hold zeros, contents and numbers below eps_numerics_2M_M/N,
and mean rain masses below xr_min and above xr_max, so every ``where``
arm and every limiter clamp is taken; both ``is_limited`` values and both
rain velocity types are covered (anchor: tests/test_m2.py).

Tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest
reference value (torch's and XLA:CPU's exp/log/pow differ by a few ULP;
the cloud PSD bounds go through four Halley steps of gamma_inc_inv in
both packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.ops import m2 as JM
from cloudmicrophysics_tpu_torch.ops import m2 as TM

RTOL, ATOL_REL = 1e-9, 1e-12
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()


def _states(n=120, seed=23):
    rng = np.random.default_rng(seed)
    s = dict(rho=rng.uniform(0.4, 1.3, n), T=rng.uniform(250.0, 305.0, n),
             q_tot=rng.uniform(0.0, 2e-2, n))
    for name, hi in (("q_lcl", 2e-3), ("q_rai", 3e-3)):
        v = rng.uniform(0.0, hi, n)
        v[rng.random(n) < 0.12] = 0.0
        v[rng.random(n) < 0.08] = 1e-17      # below eps_numerics_2M_M
        s[name] = v
    # number densities [1/m^3], log-uniform so that the mean masses run
    # from below x_min to above x_max
    s["N_lcl"] = 10 ** rng.uniform(5.0, 10.0, n)
    s["N_rai"] = 10 ** rng.uniform(0.0, 8.0, n)
    for name in ("N_lcl", "N_rai"):
        s[name][rng.random(n) < 0.1] = 0.0
        s[name][rng.random(n) < 0.05] = 1e-17   # below eps_numerics_2M_N
    s["q_icl"] = np.zeros(n)
    s["q_sno"] = np.zeros(n)
    s["D"] = 10 ** rng.uniform(-6.0, -2.0, n)
    return s


S = _states()
J = {k: jnp.asarray(v) for k, v in S.items()}
T = {k: torch.as_tensor(v) for k, v in S.items()}
XR = S["rho"] * np.maximum(S["q_rai"], 1e-30) / np.maximum(S["N_rai"], 1e-30)


def test_states_cover_every_regime():
    sb = JP.sb2006()
    assert (XR < sb.pdf_r.xr_min).any() and (XR > sb.pdf_r.xr_max).any()
    eps = np.finfo(np.float64).eps
    for name in ("q_lcl", "q_rai", "N_lcl", "N_rai"):
        assert (S[name] == 0).any() and ((S[name] > 0) & (S[name] < eps)).any()


def _close(out, ref, what="out"):
    if isinstance(ref, (tuple, list)):
        assert isinstance(out, (tuple, list)) and len(out) == len(ref), what
        for i, (a, b) in enumerate(zip(out, ref)):
            _close(a, b, f"{what}[{i}]")
        return
    if isinstance(ref, (int, float)):
        assert out == pytest.approx(ref, rel=1e-14), what
        return
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    scale = float(np.max(np.abs(ref[finite]), initial=0.0))
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-300),
                               err_msg=what)


def _sb(is_limited):
    ref = JP.sb2006(is_limited=is_limited)
    return ref, TP.sb2006(is_limited=is_limited)


LIMITED = pytest.mark.parametrize("is_limited", [True, False])


@LIMITED
@pytest.mark.parametrize("name", ["pdf_rain_parameters",
                                  "pdf_rain_parameters_mass",
                                  "size_distribution_bounds_rain"])
def test_rain_psd(is_limited, name):
    sj, st = _sb(is_limited)
    ref = getattr(JM, name)(sj.pdf_r, J["q_rai"], J["rho"], J["N_rai"])
    out = getattr(TM, name)(st.pdf_r, T["q_rai"], T["rho"], T["N_rai"])
    _close(out, ref, name)


@LIMITED
def test_size_distribution_rain(is_limited):
    sj, st = _sb(is_limited)
    _close(TM.size_distribution_rain(st.pdf_r, T["q_rai"], T["rho"],
                                     T["N_rai"], T["D"]),
           JM.size_distribution_rain(sj.pdf_r, J["q_rai"], J["rho"],
                                     J["N_rai"], J["D"]))


@pytest.mark.parametrize("name", ["log_pdf_cloud_parameters_mass",
                                  "pdf_cloud_parameters_mass",
                                  "pdf_cloud_parameters",
                                  "size_distribution_bounds_cloud"])
def test_cloud_psd(name):
    sj, st = _sb(True)
    ref = getattr(JM, name)(sj.pdf_c, J["q_lcl"], J["rho"], J["N_lcl"])
    out = getattr(TM, name)(st.pdf_c, T["q_lcl"], T["rho"], T["N_lcl"])
    _close(out, ref, name)


def test_size_distribution_cloud():
    sj, st = _sb(True)
    _close(TM.size_distribution_cloud(st.pdf_c, T["q_lcl"], T["rho"],
                                      T["N_lcl"], T["D"] * 1e-2),
           JM.size_distribution_cloud(sj.pdf_c, J["q_lcl"], J["rho"],
                                      J["N_lcl"], J["D"] * 1e-2))


def test_autoconversion_accretion_self_collection():
    sj, st = _sb(True)
    args_j = (J["q_lcl"], J["q_rai"], J["rho"], J["N_lcl"])
    args_t = (T["q_lcl"], T["q_rai"], T["rho"], T["N_lcl"])
    _close(TM.autoconversion(st.acnv, st.pdf_c, *args_t),
           JM.autoconversion(sj.acnv, sj.pdf_c, *args_j), "autoconversion")
    _close(TM.accretion(st, *args_t), JM.accretion(sj, *args_j), "accretion")
    _close(TM.autoconversion_and_cloud_liquid_self_collection(st, *args_t),
           JM.autoconversion_and_cloud_liquid_self_collection(sj, *args_j),
           "autoconversion + self-collection")
    dN = S["N_lcl"] * 1e-3
    _close(TM.cloud_liquid_self_collection(st.acnv, st.pdf_c, T["q_lcl"],
                                           T["rho"], torch.as_tensor(dN)),
           JM.cloud_liquid_self_collection(sj.acnv, sj.pdf_c, J["q_lcl"],
                                           J["rho"], jnp.asarray(dN)))


@LIMITED
def test_rain_self_collection_and_breakup(is_limited):
    sj, st = _sb(is_limited)
    args_j = (J["q_rai"], J["rho"], J["N_rai"])
    args_t = (T["q_rai"], T["rho"], T["N_rai"])
    ref = JM.rain_self_collection_and_breakup(sj, *args_j)
    out = TM.rain_self_collection_and_breakup(st, *args_t)
    _close(out, ref, "self-collection and breakup")
    _close(TM.rain_self_collection(st.pdf_r, st.self_col, *args_t),
           JM.rain_self_collection(sj.pdf_r, sj.self_col, *args_j))
    _close(TM.rain_breakup(st.pdf_r, st.brek, *args_t, out[0]),
           JM.rain_breakup(sj.pdf_r, sj.brek, *args_j, ref[0]))
    # every breakup arm (Dr < Dr_th, Dr_th <= Dr <= Deq, Dr > Deq) is taken
    xr = np.asarray(JM.pdf_rain_parameters(sj.pdf_r, J["q_rai"], J["rho"],
                                           J["N_rai"]).xr_mean)
    Dr = (xr * 6 / (np.pi * 1000.0)) ** (1 / 3)
    assert (Dr < sj.brek.Dr_th).any() and (Dr > sj.brek.Deq).any()
    assert ((Dr >= sj.brek.Dr_th) & (Dr <= sj.brek.Deq)).any()


@LIMITED
@pytest.mark.parametrize("vel", ["SB2006VelType", "Chen2022VelTypeRain"])
def test_rain_terminal_velocity(is_limited, vel):
    sj, st = _sb(is_limited)
    ref = JM.rain_terminal_velocity(sj, getattr(JP, vel)(), J["q_rai"],
                                    J["rho"], J["N_rai"])
    out = TM.rain_terminal_velocity(st, getattr(TP, vel)(), T["q_rai"],
                                    T["rho"], T["N_rai"])
    _close(out, ref, vel)


def test_rain_terminal_velocity_rejects_other_types():
    with pytest.raises(TypeError, match="unsupported rain velocity"):
        TM.rain_terminal_velocity(TP.sb2006(), TP.StokesRegimeVelType(),
                                  T["q_rai"], T["rho"], T["N_rai"])


def test_cloud_terminal_velocity():
    sj, st = _sb(True)
    _close(TM.cloud_terminal_velocity(st.pdf_c, TP.StokesRegimeVelType(),
                                      T["q_lcl"], T["rho"], T["N_lcl"]),
           JM.cloud_terminal_velocity(sj.pdf_c, JP.StokesRegimeVelType(),
                                      J["q_lcl"], J["rho"], J["N_lcl"]))


@pytest.mark.parametrize("a", [-1.0, -0.101])
def test_gamma_incl_approx(a):
    x = np.linspace(0.067, 1.82, 25)
    _close(TM.gamma_incl_approx(a, torch.as_tensor(x)),
           JM.gamma_incl_approx(a, jnp.asarray(x)))


@LIMITED
@pytest.mark.parametrize("name", ["rain_evaporation",
                                  "d_rain_evaporation_d_N_rai_d_q_rai"])
def test_rain_evaporation(is_limited, name):
    mp_j = JP.microphysics_2m_params(is_limited=is_limited)
    mp_t = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(mp_j))
    wj, wt = mp_j.warm_rain, mp_t.warm_rain
    keys = ("q_tot", "q_lcl", "q_icl", "q_rai", "q_sno", "rho", "N_rai", "T")
    ref = getattr(JM, name)(wj.seifert_beheng, wj.air_properties, TPS_J,
                            *(J[k] for k in keys))
    out = getattr(TM, name)(wt.seifert_beheng, wt.air_properties, TPS_T,
                            *(T[k] for k in keys))
    _close(out, ref, name)
    if name == "rain_evaporation":
        assert (np.asarray(ref[1]) < 0).any() and (np.asarray(ref[1]) == 0).any()


def test_number_tendency_from_mass_limits():
    sj, st = _sb(True)
    n = S["N_rai"] / S["rho"]
    for lo, hi in ((sj.pdf_c.xc_min, sj.pdf_c.xc_max),
                   (sj.pdf_r.xr_min, sj.pdf_r.xr_max)):
        _close(TM.number_tendency_from_mass_limits(
                   lo, hi, st.numadj.tau, T["q_rai"], torch.as_tensor(n)),
               JM.number_tendency_from_mass_limits(
                   lo, hi, sj.numadj.tau, J["q_rai"], jnp.asarray(n)))


@pytest.mark.parametrize("smooth", [False, True])
def test_legacy_autoconversion(smooth):
    N_d = np.linspace(5e7, 5e8, len(S["rho"]))
    args_j = (J["q_lcl"], J["rho"], jnp.asarray(N_d))
    args_t = (T["q_lcl"], T["rho"], torch.as_tensor(N_d))
    _close(TM.conv_q_lcl_to_q_rai_kk2000(TP.m2.kk2000(), *args_t),
           JM.conv_q_lcl_to_q_rai_kk2000(JP.m2.kk2000(), *args_j), "kk2000")
    for name, params in (("b1994", "b1994"), ("tc1980", "tc1980"),
                         ("ld2004", "LD2004")):
        fn = f"conv_q_lcl_to_q_rai_{name}"
        _close(getattr(TM, fn)(getattr(TP.m2, params)(), *args_t,
                               smooth_transition=smooth),
               getattr(JM, fn)(getattr(JP.m2, params)(), *args_j,
                               smooth_transition=smooth), name)


def test_legacy_accretion():
    args_j = (J["q_lcl"], J["q_rai"], J["rho"])
    args_t = (T["q_lcl"], T["q_rai"], T["rho"])
    _close(TM.accretion_kk2000(TP.m2.kk2000(), *args_t),
           JM.accretion_kk2000(JP.m2.kk2000(), *args_j), "kk2000")
    _close(TM.accretion_b1994(TP.m2.b1994(), *args_t),
           JM.accretion_b1994(JP.m2.b1994(), *args_j), "b1994")
    _close(TM.accretion_tc1980(TP.m2.tc1980(), *args_t[:2]),
           JM.accretion_tc1980(JP.m2.tc1980(), *args_j[:2]), "tc1980")

