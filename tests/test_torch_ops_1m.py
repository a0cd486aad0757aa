"""Float64 parity of the port's ops (thermo, common, noneq, m0, m1) with
the JAX package, on the same numpy-built states.

Tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest
reference value. torch's exp/log/pow and XLA:CPU's differ by a few ULP,
and a few terms (supersaturation near saturation, the Chen 2022
small-ice velocity, a difference of two ~3 terms) cancel, which lifts
relative differences of near-zero values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.ops as JO
import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.ops as TO
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.parameters.aerosol_species import (
    H2SO4SolutionParameters)

RTOL, ATOL_REL = 1e-9, 1e-12

# option slot -> alternative values, as tests/test_1m_options.py covers
ALTERNATIVES = {
    "cloud_liquid_formation": [None],
    "cloud_ice_formation": ["TemperatureDependent", None],
    "cloud_ice_melt": [None],
    "rain_autoconversion": ["PrescribedNd", None],
    "snow_autoconversion": ["WithSupersaturation", None],
    "rain_condensation_evaporation": [None],
    "snow_deposition_sublimation": ["SublimationOnly", None],
    "snow_melt": [None],
    "cloud_liquid_rain_accretion": [None],
    "cloud_liquid_snow_accretion": [None],
    "cloud_ice_rain_accretion": [None],
    "cloud_ice_snow_accretion": [None],
    "rain_snow_accretion": [None],
}

TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
TV_J, TV_T = JP.terminal_velocity_params(), TP.terminal_velocity_params()


def _states(n=96, seed=11):
    """Random cells plus the fixed states of tests/test_m1.py: both sides of
    freezing, zero and slightly negative contents (the clamps), sub- and
    supersaturated air."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.4, 1.3, n)
    T = rng.uniform(225.0, 305.0, n)
    q = {"q_tot": rng.uniform(0.0, 2e-2, n)}
    for name, scale in (("q_lcl", 2e-3), ("q_icl", 1e-3), ("q_rai", 2e-3),
                        ("q_sno", 1e-3)):
        v = rng.uniform(0.0, scale, n)
        v[rng.random(n) < 0.2] = 0.0
        v[rng.random(n) < 0.05] = -1e-6
        q[name] = v
    t_frz = TPS_J.T_freeze
    fixed = [  # (rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno)
        (1.2, t_frz + 5, 20e-3, 5e-4, 5e-4, 5e-4, 5e-4),
        (1.2, t_frz - 5, 20e-3, 5e-4, 5e-4, 5e-4, 5e-4),
        (1.2, t_frz + 2, 0.0, 0.0, 1e-4, 0.0, 1e-4),
        (1.0, 280.0, 15e-3, 1e-3, 0.0, 2e-3, 0.0),
        (1.1, 250.0, 8e-3, 0.0, 3e-3, 0.0, 1e-3),
        (1.2, t_frz, 1e-3, 0.0, 0.0, 0.0, 0.0),
    ]
    for i, row in enumerate(fixed):
        rho[i], T[i] = row[0], row[1]
        for name, v in zip(("q_tot", "q_lcl", "q_icl", "q_rai", "q_sno"),
                           row[2:]):
            q[name][i] = v
    return dict(rho=rho, T=T, **q)


S = _states()


def _micro_thermo(ops, to_array):
    micro = ops.MicroState(*(to_array(S[k]) for k in
                             ("q_tot", "q_lcl", "q_icl", "q_rai", "q_sno")))
    return micro, ops.ThermoState(to_array(S["rho"]), to_array(S["T"]))


J_ARR = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
T_ARR = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _assert_close(out, ref, what):
    outs, refs = _leaves(out), _leaves(ref)
    assert len(outs) == len(refs), what
    for i, (a, b) in enumerate(zip(outs, refs)):
        if a is None and b is None:
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b, dtype=np.float64)
        a = np.broadcast_to(np.asarray(a, np.float64), b.shape)
        atol = ATOL_REL * max(float(np.max(np.abs(b), initial=0.0)), 1e-300)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=f"{what}[{i}]")


def _both(fn, mp_j=None, mp_t=None):
    """Run ``fn(ops, P, mp, tps, tv, micro, thermo, arr)`` on both sides."""
    mj, thj = _micro_thermo(JO, J_ARR)
    mt, tht = _micro_thermo(TO, T_ARR)
    ref = fn(JO, JP, mp_j, TPS_J, TV_J, mj, thj, J_ARR)
    out = fn(TO, TP, mp_t, TPS_T, TV_T, mt, tht, T_ARR)
    return out, ref


def _port_mp(mp_j):
    return TP.from_tree(TP.Microphysics1MParams, dataclasses.asdict(mp_j))


MP_J = JP.microphysics_1m_params()
MP_T = _port_mp(MP_J)

# ---------------------------------------------------------------------------
# thermo / common / m0 / noneq
# ---------------------------------------------------------------------------

OPS = {
    "latent_heat_vapor": lambda o, P, mp, tps, tv, mi, th, a:
        o.thermo.latent_heat_vapor(tps, th.T),
    "latent_heat_sublim": lambda o, P, mp, tps, tv, mi, th, a:
        o.thermo.latent_heat_sublim(tps, th.T),
    "latent_heat_fusion": lambda o, P, mp, tps, tv, mi, th, a:
        o.thermo.latent_heat_fusion(tps, th.T),
    "saturation_vapor_pressure": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.saturation_vapor_pressure_over_liquid(tps, th.T),
        o.thermo.saturation_vapor_pressure_over_ice(tps, th.T)),
    "saturation_vapor_specific_content": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.saturation_vapor_specific_content_over_liquid(
            tps, th.T, th.rho),
        o.thermo.saturation_vapor_specific_content_over_ice(
            tps, th.T, th.rho)),
    "supersaturation": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.supersaturation_over_liquid(
            tps, mi.q_tot, mi.q_lcl + mi.q_rai, mi.q_icl + mi.q_sno,
            th.rho, th.T),
        o.thermo.supersaturation_over_ice(
            tps, mi.q_tot, mi.q_lcl + mi.q_rai, mi.q_icl + mi.q_sno,
            th.rho, th.T)),
    "q_vap": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.q_vap(mi.q_tot, mi.q_lcl, mi.q_icl),
        o.thermo.q_vap5(*mi)),
    "p2q_q2p": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.p2q(tps, th.T, th.rho, 1e3 * mi.q_tot),
        o.thermo.q2p(tps, th.T, th.rho, mi.q_tot)),
    "gas_constant_cp_density": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.gas_constant_air(tps, mi.q_tot, mi.q_lcl, mi.q_icl),
        o.thermo.cp_m(tps, mi.q_tot, mi.q_lcl, mi.q_icl),
        o.thermo.air_density(tps, th.T, 1e5 * th.rho, mi.q_tot, mi.q_lcl,
                             mi.q_icl)),
    "liquid_fraction": lambda o, P, mp, tps, tv, mi, th, a:
        o.thermo.liquid_fraction(tps, th.T, mi.q_lcl, mi.q_icl),
    "internal_energy": lambda o, P, mp, tps, tv, mi, th, a: (
        o.thermo.internal_energy_liquid(tps, th.T),
        o.thermo.internal_energy_ice(tps, th.T)),
    "G_func": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.G_func_liquid(P.AirProperties(), tps, th.T),
        o.common.G_func_ice(P.AirProperties(), tps, th.T)),
    "logistic_function": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.logistic_function(mi.q_lcl, 5e-4, 2.0),
        o.common.logistic_function(mi.q_lcl, 0.0, 2.0)),
    "logistic_function_integral": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.logistic_function_integral(mi.q_lcl, 5e-4, 2.0),
        o.common.logistic_function_integral(mi.q_icl, 1e-6, 3.0),
        o.common.logistic_function_integral(mi.q_lcl, 0.0, 2.0)),
    "chen2022_vel_coeffs": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.chen2022_vel_coeffs_rain(tv.chen2022.rain, th.rho),
        o.common.chen2022_vel_coeffs_small_ice(
            tv.chen2022.small_ice, th.rho, 500.0),
        o.common.chen2022_vel_coeffs_large_ice(
            tv.chen2022.large_ice, th.rho, 100.0)),
    "chen2022_small_ice_tensor_rho_i": lambda o, P, mp, tps, tv, mi, th, a:
        o.common.chen2022_vel_coeffs_small_ice(
            tv.chen2022.small_ice, th.rho, a(np.float64(500.0))),
    "chen2022_sums": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.chen2022_exponential_pdf(
            1.3, 2.2 + 0.1 * th.rho, 184.0, 1e-4 + 0.01 * mi.q_tot, 3),
        o.common.chen2022_velocity_sum(
            *o.common.chen2022_vel_coeffs_rain(tv.chen2022.rain, th.rho),
            1e-4 + 0.1 * mi.q_tot)),
    "ventilation_volume": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.ventilation_factor(mp.precip.rain.vent, P.AirProperties(),
                                    th.rho, 1e-3 + mi.q_tot),
        o.common.volume_sphere_D(mi.q_tot), o.common.volume_sphere_R(mi.q_tot)),
    "water_activity": lambda o, P, mp, tps, tv, mi, th, a: (
        o.common.a_w_eT(tps, 1e5 * mi.q_tot, th.T),
        o.common.a_w_ice(tps, th.T),
        o.common.a_w_xT(H2SO4SolutionParameters(), tps, 10 * mi.q_tot, th.T)),
    "m0": lambda o, P, mp, tps, tv, mi, th, a: (
        o.m0.remove_precipitation(P.microphysics_0m_params().precip,
                                  mi.q_lcl, mi.q_icl),
        o.m0.remove_precipitation(P.microphysics_0m_params().precip,
                                  mi.q_lcl, mi.q_icl, 0.5 * mi.q_tot),
        o.m0.d_remove_precipitation_dq_tot(
            P.microphysics_0m_params().precip, mi.q_lcl, mi.q_icl)),
    "noneq_cloud_velocities": lambda o, P, mp, tps, tv, mi, th, a: (
        o.noneq.terminal_velocity(mp.cloud.liquid, tv.stokes, th.rho,
                                  mi.q_lcl),
        o.noneq.terminal_velocity(mp.cloud.ice, tv.chen2022.small_ice,
                                  th.rho, mi.q_icl)),
    "noneq_frostenberg": lambda o, P, mp, tps, tv, mi, th, a: (
        o.noneq.inp_concentration_mean(P.Frostenberg2023(), th.T),
        o.noneq.tau_relax_frostenberg(mp.cloud.ice, P.AirProperties(),
                                      P.Frostenberg2023(), mi.q_icl, th.T)),
    "noneq_helpers": lambda o, P, mp, tps, tv, mi, th, a: (
        o.noneq.dqcld_dT(mi.q_tot, 2.5e6, tps.R_v, th.T),
        o.noneq.gamma_helper(2.5e6, 1004.0 + mi.q_tot, mi.q_lcl)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches(name):
    out, ref = _both(OPS[name], MP_J, MP_T)
    _assert_close(out, ref, name)


def test_inp_limiter_matches():
    out, ref = _both(lambda o, P, mp, tps, tv, mi, th, a: o.noneq.inp_limiter(
        mi.q_lcl - 1e-4, tps, th.T), MP_J, MP_T)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# ops/m1 and the cloud condensate rates, under every option variant
# ---------------------------------------------------------------------------

def _sd(o, mp, mi, th):
    return o.m1.size_distr_parameters(mp, mi, th)


RATES = {
    "conv_q_vap_to_q_lcl": lambda o, mp, tps, mi, th, sd:
        o.noneq.conv_q_vap_to_q_lcl(mp, tps, mi, th),
    "conv_q_vap_to_q_icl": lambda o, mp, tps, mi, th, sd:
        o.noneq.conv_q_vap_to_q_icl(mp, tps, mi, th),
    "conv_q_lcl_to_q_rai": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_lcl_to_q_rai(mp, tps, mi, th),
    "conv_q_icl_to_q_sno": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_icl_to_q_sno(mp, tps, mi, th, sd),
    "accretion_cloud_liquid_rain": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_cloud_liquid_rain(mp, tps, mi, th, sd),
    "accretion_cloud_liquid_snow": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_cloud_liquid_snow(mp, tps, mi, th, sd),
    "accretion_cloud_ice_rain": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_cloud_ice_rain(mp, tps, mi, th, sd),
    "accretion_cloud_ice_snow": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_cloud_ice_snow(mp, tps, mi, th, sd),
    "accretion_rain_sink": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_rain_sink(mp, tps, mi, th, sd),
    "accretion_snow_rain": lambda o, mp, tps, mi, th, sd:
        o.m1.accretion_snow_rain(mp, tps, mi, th, sd),
    "conv_q_rai_to_q_vap": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_rai_to_q_vap(mp, tps, mi, th, sd),
    "conv_q_sno_to_q_vap": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_sno_to_q_vap(mp, tps, mi, th, sd),
    "conv_q_icl_to_q_lcl": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_icl_to_q_lcl(mp, tps, mi, th, sd),
    "conv_q_sno_to_q_rai": lambda o, mp, tps, mi, th, sd:
        o.m1.conv_q_sno_to_q_rai(mp, tps, mi, th, sd),
}

VARIANTS = [(None, None)] + [(s, v) for s, vals in ALTERNATIVES.items()
                             for v in vals]


@pytest.mark.parametrize("slot,value", VARIANTS)
def test_every_rate_matches_under_option(slot, value):
    # the clamped state the source-term pass hands to the rates
    kwargs = {} if slot is None else {slot: value}
    mp_j = JP.microphysics_1m_params(**kwargs)
    mp_t = _port_mp(mp_j)
    for shared_sd in (True, False):
        for name, rate in RATES.items():
            def fn(o, P, mp, tps, tv, mi, th, a, rate=rate):
                mi = o.MicroState(*(v * (v > 0) for v in mi))
                sd = _sd(o, mp, mi, th) if shared_sd else None
                return rate(o, mp, tps, mi, th, sd)
            out, ref = _both(fn, mp_j, mp_t)
            _assert_close(out, ref, f"{name} sd={shared_sd}")


def test_size_distr_parameters_match():
    def fn(o, P, mp, tps, tv, mi, th, a):
        mi = o.MicroState(*(v * (v > 0) for v in mi))
        return tuple(_sd(o, mp, mi, th))
    out, ref = _both(fn, MP_J, MP_T)
    _assert_close(out, ref, "size_distr_parameters")


M1_HELPERS = {
    "lambda_inverse": lambda o, mp, tv, mi, th: (
        o.m1.lambda_inverse(mp.precip.rain.pdf, mp.precip.rain.mass,
                            mi.q_rai, th.rho),
        o.m1.lambda_inverse(mp.precip.snow.pdf, mp.precip.snow.mass,
                            mi.q_sno, th.rho),
        o.m1.lambda_inverse(mp.cloud.ice.pdf, mp.cloud.ice.mass,
                            mi.q_icl, th.rho)),
    "get_n0_v0": lambda o, mp, tv, mi, th: (
        o.m1.get_n0(mp.precip.snow.pdf, mi.q_sno, th.rho),
        o.m1.get_v0(mp.terminal_velocity.rain, th.rho)),
    "terminal_velocity_blk1m": lambda o, mp, tv, mi, th: (
        o.m1.terminal_velocity(mp.precip.rain, mp.terminal_velocity.rain,
                               th.rho, mi.q_rai),
        o.m1.terminal_velocity(mp.precip.snow, mp.terminal_velocity.snow,
                               th.rho, mi.q_sno)),
    "terminal_velocity_chen2022": lambda o, mp, tv, mi, th: (
        o.m1.terminal_velocity(mp.precip.rain, tv.chen2022.rain, th.rho,
                               mi.q_rai),
        o.m1.terminal_velocity(mp.precip.snow, tv.chen2022.large_ice,
                               th.rho, mi.q_sno),
        o.m1.terminal_velocity(mp.precip.snow, tv.chen2022.large_ice,
                               th.rho, mi.q_sno, snow_shape="Oblate"),
        o.m1.terminal_velocity(mp.precip.snow, tv.chen2022.large_ice,
                               th.rho, mi.q_sno, snow_shape="Prolate")),
    "warm_accretion_melt_factor": lambda o, mp, tv, mi, th:
        o.m1.warm_accretion_melt_factor(TPS_J if o is JO else TPS_T, th.T),
}


@pytest.mark.parametrize("name", sorted(M1_HELPERS))
def test_m1_helper_matches(name):
    def fn(o, P, mp, tps, tv, mi, th, a):
        return M1_HELPERS[name](o, mp, tv, mi, th)
    out, ref = _both(fn, MP_J, MP_T)
    _assert_close(out, ref, name)


@pytest.mark.parametrize("shape", ["Oblate", "Prolate"])
def test_aspect_ratio_coeffs_match(shape):
    snow_j, snow_t = MP_J.precip.snow, MP_T.precip.snow
    ref = JO.m1.aspect_ratio_coeffs(shape, snow_j.mass, snow_j.area,
                                    snow_j.rho_i)
    out = TO.m1.aspect_ratio_coeffs(shape, snow_t.mass, snow_t.area,
                                    snow_t.rho_i)
    np.testing.assert_allclose(out, [float(v) for v in ref], rtol=1e-15)
