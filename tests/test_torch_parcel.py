"""The port's 0-D drivers (parcel, box, P3 sandbox) against the JAX package
at float64, on the CPU.

* ``parcel_tendencies`` for every process option of ``ParcelParams``, at
  every state of a JAX trajectory (so that no error compounds): rtol 1e-9
  with an absolute floor of 1e-12 of the field's largest magnitude.
* ``run_parcel`` on each configuration of ``tests/test_parcel.py`` over
  the whole trajectory: rtol 1e-6 with the same floor.
* The Frostenberg random and stochastic variants, whose random streams
  differ between the packages, stepped with the same injected normal
  draws through ``parcel_tendencies``: rtol 1e-6 over the trajectory.
* An ensemble member against its single run, and per-member tensor
  parameters against per-member runs with float parameters: rtol 1e-12
  (on the CPU PyTorch's vectorised and scalar loops may round a
  transcendental differently, and a float and a tensor parameter round
  differently; the card holds the member bit for bit, ``chip_smoke.py``).
* A seeded generator reproduces its trajectory bit for bit.
* The deterministic box and the P3 sandbox at rtol 1e-9; one step of the
  stochastic box with injected uniforms against the JAX scan body.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import box as JBOX
from cloudmicrophysics_tpu.models import p3_sandbox as JSB
from cloudmicrophysics_tpu.models import parcel as JPM
from cloudmicrophysics_tpu.ops import common as JCO
from cloudmicrophysics_tpu.ops import ice_nucleation as JIN
from cloudmicrophysics_tpu.ops import thermo as JTD
from cloudmicrophysics_tpu.parameters import aerosol_species as JSP
from cloudmicrophysics_tpu_torch.models import box as TBOX
from cloudmicrophysics_tpu_torch.models import p3_sandbox as TSB
from cloudmicrophysics_tpu_torch.models import parcel as TPM
from cloudmicrophysics_tpu_torch.parameters import aerosol_species as TSP

RTOL_STEP, RTOL_TRAJ, ATOL_REL = 1e-9, 1e-6, 1e-12
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
F = jnp.float64


def _close(got, want, rtol, what):
    """Per field: rtol with an absolute floor of ATOL_REL of the field's
    largest finite magnitude; non-finite values must coincide."""
    for name, g, w in zip(want._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin,
                                      err_msg=f"{what}.{name}")
        atol = ATOL_REL * float(np.max(np.abs(w[fin]), initial=0.0))
        np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=atol,
                                   err_msg=f"{what}.{name}")


# ---------------------------------------------------------------------------
# initial conditions (as tests/test_parcel.py builds them), numpy floats
# ---------------------------------------------------------------------------

def liquid_ic(T0=273.15 + 7.0, p0=800e2, N_liq=200e6, r0=8e-6, **over):
    e = float(JTD.saturation_vapor_pressure_over_liquid(TPS_J, F(T0)))
    md = (p0 - e) / TPS_J.R_d / T0
    mv = e / TPS_J.R_v / T0
    ml = N_liq * 4 / 3 * np.pi * 1000.0 * r0**3
    ic = dict(S_l=1.0, p_air=p0, T=T0, q_vap=mv / (md + mv + ml),
              q_liq=ml / (md + mv + ml), q_ice=0.0, N_aer=0.0, N_liq=N_liq,
              N_ice=0.0, ln_inpc=0.0)
    ic.update(over)
    return ic


def cold_ic(T0=220.0, Si0=1.3, N_aer=2000.0, **over):
    p0 = 20000.0
    e_sl = float(JTD.saturation_vapor_pressure_over_liquid(TPS_J, F(T0)))
    e_si = float(JTD.saturation_vapor_pressure_over_ice(TPS_J, F(T0)))
    S_l = Si0 * e_si / e_sl
    e = S_l * e_sl
    md = (p0 - e) / TPS_J.R_d / T0
    mv = e / TPS_J.R_v / T0
    ic = dict(S_l=S_l, p_air=p0, T=T0, q_vap=mv / (md + mv), q_liq=0.0,
              q_ice=0.0, N_aer=N_aer, N_liq=0.0, N_ice=0.0, ln_inpc=0.0)
    ic.update(over)
    return ic


def _ln_inpc(T0):
    return float(np.log(np.maximum(1e-10, ((273.15 - T0) / 10) ** 9)))


def _jax_state(ic):
    return JPM.ParcelState(**{k: F(v) for k, v in ic.items()})


def _torch_state(ic, dtype=torch.float64):
    return TP.parcel_state_from_numpy(
        {k: np.array(v) for k, v in ic.items()}, device="cpu", dtype=dtype)


def _params(**opts):
    """The JAX parameters and the port's, rebuilt by ``from_tree``."""
    pj = JPM.parcel_params(**opts)
    aerosol = opts.pop("aerosol", None)
    pt = TP.from_tree(TPM.ParcelParams, dataclasses.asdict(pj))
    want = TPM.parcel_params(**opts, aerosol=None if aerosol is None else
                             getattr(TSP, type(aerosol).__name__)())
    assert pt == want
    return pj, pt


MIXED = dict(T0=251.0, p0=80000.0, N_liq=1e8, r0=1e-6)
DESERT, ILLITE, SULFATE = JSP.DesertDust(), JSP.Illite(), JSP.Sulfate()

# every process option of ParcelParams (parcel.py:63-76), each with a state
# it acts on and a short trajectory of JAX states (const_dt, n_steps)
OPTIONS = {
    "aerosol_act=AeroAct": (
        dict(aerosol_act="AeroAct", aerosol=SULFATE, aero_sigma_g=2.0,
             condensation_growth="Condensation", N_aer_act=1e9, w=2.0),
        liquid_ic(S_l=1.002, N_aer=1e9, N_liq=1e6, r0=2e-6), 0.1, 40),
    "deposition=MohlerAF": (
        dict(deposition="MohlerAF", aerosol=DESERT,
             deposition_growth="Deposition", w=3.5), cold_ic(), 0.1, 40),
    "deposition=MohlerRate": (
        dict(deposition="MohlerRate", aerosol=DESERT,
             deposition_growth="Deposition", w=3.5), cold_ic(Si0=1.15),
        0.1, 40),
    "deposition=ABDINM": (
        dict(deposition="ABDINM", aerosol=DESERT,
             deposition_growth="Deposition", w=1.0),
        cold_ic(N_aer=1e6), 0.1, 40),
    "deposition=P3_dep": (
        dict(deposition="P3_dep", deposition_growth="Deposition", w=1.0),
        cold_ic(T0=240.0, Si0=1.2, N_aer=1e6), 0.1, 40),
    "heterogeneous=ABIFM": (
        dict(heterogeneous="ABIFM", aerosol=ILLITE,
             condensation_growth="Condensation", w=0.7),
        liquid_ic(**MIXED), 0.25, 40),
    # on tests/test_parcel.py's P3 state: at 251 K and 1 um droplets the
    # frozen share 1 - exp(-x) has x ~ 1e-12 and keeps only ~4 digits in
    # either package (tests/test_torch_ice_nucleation.py)
    "heterogeneous=P3_het": (
        dict(heterogeneous="P3_het", deposition_growth="Deposition", w=1.0),
        cold_ic(T0=240.0, Si0=1.2, N_aer=1e6, N_liq=1e6, q_liq=1e-5),
        0.1, 40),
    "heterogeneous=Frostenberg_mean": (
        dict(heterogeneous="Frostenberg_mean",
             condensation_growth="Condensation", w=0.7),
        liquid_ic(**MIXED, ln_inpc=_ln_inpc(251.0)), 0.25, 40),
    "heterogeneous=Frostenberg_random": (
        dict(heterogeneous="Frostenberg_random",
             condensation_growth="Condensation", w=0.7,
             sampling_interval=1.0),
        liquid_ic(**MIXED, ln_inpc=_ln_inpc(251.0)), 0.25, 40),
    "heterogeneous=Frostenberg_stochastic": (
        dict(heterogeneous="Frostenberg_stochastic",
             condensation_growth="Condensation", w=0.7, gamma=1.0),
        liquid_ic(**MIXED, ln_inpc=_ln_inpc(251.0)), 0.25, 40),
    "homogeneous=ABHOM": (
        dict(homogeneous="ABHOM", deposition_growth="Deposition", w=1.0),
        liquid_ic(T0=233.2, p0=30000.0, N_liq=1e8, r0=1e-6, S_l=1.05),
        0.1, 40),
    "homogeneous=P3_hom": (
        dict(homogeneous="P3_hom", deposition_growth="Deposition", w=1.0),
        cold_ic(T0=232.0, Si0=1.2, N_aer=1e6, N_liq=1e6, q_liq=1e-5),
        0.1, 40),
    "condensation_growth=NonEq_Condensation": (
        dict(condensation_growth="NonEq_Condensation", w=2.0),
        liquid_ic(S_l=1.003), 0.25, 40),
    "condensation_growth=NonEq_Condensation_simple": (
        dict(condensation_growth="NonEq_Condensation_simple", w=2.0),
        liquid_ic(S_l=1.003), 0.25, 40),
    "deposition_growth=NonEq_Deposition": (
        dict(deposition="P3_dep", deposition_growth="NonEq_Deposition",
             w=1.0), cold_ic(T0=240.0, Si0=1.2, N_aer=1e6), 0.1, 40),
    "deposition_growth=NonEq_Deposition_simple": (
        dict(deposition="P3_dep", deposition_growth="NonEq_Deposition_simple",
             w=1.0), cold_ic(T0=240.0, Si0=1.2, N_aer=1e6), 0.1, 40),
    "liq_size_distribution=Gamma": (
        dict(liq_size_distribution="Gamma",
             condensation_growth="Condensation", w=10.0),
        liquid_ic(), 0.5, 40),
    "ice_size_distribution=Gamma": (
        dict(ice_size_distribution="Gamma", deposition="MohlerAF",
             aerosol=DESERT, deposition_growth="Deposition", w=3.5),
        cold_ic(), 0.1, 40),
}
DRAWS = np.array([0.37, -1.21])


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_parcel_tendencies_match_jax(option):
    opts, ic, const_dt, n = OPTIONS[option]
    pj, pt = _params(**dict(opts, const_dt=const_dt))
    traj = JPM.run_parcel(_jax_state(ic), 0.0, n * const_dt, pj,
                          rng_key=jax.random.PRNGKey(1))
    states = {k: np.asarray(v) for k, v in traj._asdict().items()}
    # the previous step's dS/dt, by differences of the trajectory
    dS_prev = np.concatenate([[0.0], np.diff(states["S_l"]) / const_dt])
    t = const_dt * np.arange(n + 1)
    want = jax.jit(lambda y, t, d: JPM.parcel_tendencies(
        pj, y, t, d, jnp.asarray(DRAWS)))(
        JPM.ParcelState(**{k: jnp.asarray(v) for k, v in states.items()}),
        jnp.asarray(t), jnp.asarray(dS_prev))
    got = TPM.parcel_tendencies(pt, _torch_state(states), torch.tensor(t),
                                torch.tensor(dS_prev), torch.tensor(DRAWS))
    _close(got, want, RTOL_STEP, option)


def test_parcel_tendencies_take_a_python_time():
    opts, ic, const_dt, _ = OPTIONS["heterogeneous=Frostenberg_random"]
    pj, pt = _params(**dict(opts, const_dt=const_dt))
    for t in (0.0, 0.25, 3.0):
        want = JPM.parcel_tendencies(pj, _jax_state(ic), t, F(0.0),
                                     jnp.asarray(DRAWS))
        got = TPM.parcel_tendencies(pt, _torch_state(ic), t,
                                    torch.tensor(0.0, dtype=torch.float64),
                                    torch.tensor(DRAWS))
        _close(got, want, RTOL_STEP, f"t={t}")


# the configurations of tests/test_parcel.py: (options, ic, t_end)
RUNS = {
    "rogers_monodisperse": (
        dict(liq_size_distribution="Monodisperse",
             condensation_growth="Condensation", const_dt=0.5, w=10.0),
        liquid_ic(), 20.0),
    "rogers_gamma": (
        dict(liq_size_distribution="Gamma",
             condensation_growth="Condensation", const_dt=0.5, w=10.0),
        liquid_ic(), 20.0),
    "deposition_mohler_af": (
        dict(deposition="MohlerAF", aerosol=DESERT,
             deposition_growth="Deposition", const_dt=0.1, w=3.5),
        cold_ic(), 30.0),
    "immersion_abifm": (
        dict(heterogeneous="ABIFM", aerosol=ILLITE,
             condensation_growth="Condensation", const_dt=0.25, w=0.7),
        liquid_ic(**MIXED), 60.0),
    "homogeneous_abhom": (
        dict(homogeneous="ABHOM", deposition_growth="Deposition",
             const_dt=0.1, w=1.0),
        liquid_ic(T0=233.2, p0=30000.0, N_liq=1e8, r0=1e-6, S_l=1.05),
        30.0),
    "frostenberg_mean": (
        dict(heterogeneous="Frostenberg_mean",
             condensation_growth="Condensation", const_dt=0.25, w=0.7,
             sampling_interval=1.0, gamma=1.0),
        liquid_ic(**MIXED, ln_inpc=_ln_inpc(251.0)), 20.0),
    "p3_modes": (
        dict(deposition="P3_dep", heterogeneous="P3_het",
             homogeneous="P3_hom", deposition_growth="Deposition",
             const_dt=0.1, w=1.0),
        cold_ic(T0=240.0, Si0=1.2, N_aer=1e6, N_liq=1e6, q_liq=1e-5), 10.0),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_parcel_matches_jax(run):
    opts, ic, t_end = RUNS[run]
    pj, pt = _params(**opts)
    want = JPM.run_parcel(_jax_state(ic), 0.0, t_end, pj)
    got = TPM.run_parcel(_torch_state(ic), 0.0, t_end, pt)
    assert got.T.shape[0] == int(round(t_end / opts["const_dt"])) + 1
    _close(got, want, RTOL_TRAJ, run)


def test_run_parcel_ensemble_matches_jax_vmap():
    """tests/test_parcel.py's vmapped ensemble: a state of shape (3,)."""
    pj, pt = _params(condensation_growth="Condensation", const_dt=0.5,
                     w=10.0)
    ics = [liquid_ic(N_liq=n) for n in (50e6, 200e6, 800e6)]
    stacked = {k: np.array([ic[k] for ic in ics]) for k in ics[0]}
    want = jax.vmap(lambda ic: JPM.run_parcel(ic, 0.0, 10.0, pj))(
        JPM.ParcelState(**{k: jnp.asarray(v) for k, v in stacked.items()}))
    got = TPM.run_parcel(_torch_state(stacked), 0.0, 10.0, pt)
    # vmap puts the member axis first, the port the time axis
    _close(type(got)(*(v.T for v in got)), want, RTOL_TRAJ, "ensemble")


@pytest.mark.parametrize("variant", ["Frostenberg_random",
                                     "Frostenberg_stochastic"])
def test_random_variants_with_injected_draws(variant):
    opts, ic, const_dt, _ = OPTIONS[f"heterogeneous={variant}"]
    pj, pt = _params(**dict(opts, const_dt=const_dt))
    draws = np.random.default_rng(17).normal(size=(60, 2))
    yj, yt = _jax_state(ic), _torch_state(ic)
    dj, dt_ = F(0.0), torch.tensor(0.0, dtype=torch.float64)
    step = jax.jit(lambda y, t, d, r: JPM.parcel_tendencies(pj, y, t, d, r))
    for i, r in enumerate(draws):
        t = i * const_dt
        dyj = step(yj, t, dj, jnp.asarray(r))
        dyt = TPM.parcel_tendencies(pt, yt, t, dt_, torch.tensor(r))
        yj = JPM.ParcelState(*(v + const_dt * d for v, d in zip(yj, dyj)))
        yt = TPM.ParcelState(*(v + const_dt * d for v, d in zip(yt, dyt)))
        dj, dt_ = dyj.S_l, dyt.S_l
    _close(yt, yj, RTOL_TRAJ, variant)
    assert float(yt.N_ice) > 0


def test_frostenberg_random_samples_on_the_jax_float32_steps():
    """A float32 parcel samples INPC where the JAX package's float32
    program does (x64 off): its time is t_0 + i * dt in float32, not in
    float64. At dt = 0.3 s and a 1 s interval a float64 time would also
    sample at steps 50 and 90 (50 * 0.3 rounds to 15.0 in float64, while
    float32's 0.3 times 50 rounds to 15.000001). With sigma 0 the sample
    is exp(mu(T)), so JAX's random stream plays no part. N_ice agrees at
    rtol 1e-6 (measured 5.5e-7: float32 rounding of the condensation over
    100 steps)."""
    opts = dict(heterogeneous="Frostenberg_random",
                condensation_growth="Condensation", w=0.7,
                sampling_interval=1.0, const_dt=0.3)
    ic = liquid_ic(**MIXED, ln_inpc=_ln_inpc(251.0))
    pj = JPM.parcel_params(**opts, ip=JP.Frostenberg2023(sigma=0.0))
    pt = TPM.parcel_params(**opts, ip=TP.Frostenberg2023(sigma=0.0))
    with jax.enable_x64(False):
        want = JPM.run_parcel(JPM.ParcelState(**{
            k: jnp.float32(v) for k, v in ic.items()}), 0.0, 30.0, pj)
        want = np.asarray(want.N_ice)
    assert want.dtype == np.float32
    got = TPM.run_parcel(_torch_state(ic, torch.float32), 0.0, 30.0,
                         pt).N_ice.numpy()
    sampled = np.flatnonzero(np.diff(want) > 0)
    np.testing.assert_array_equal(np.flatnonzero(np.diff(got) > 0), sampled)
    assert 50 not in sampled and 40 in sampled
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_run_parcel_draws_from_its_generator():
    opts, ic, const_dt, _ = OPTIONS["heterogeneous=Frostenberg_stochastic"]
    _, pt = _params(**dict(opts, const_dt=const_dt))
    st = _torch_state(ic)
    runs = [TPM.run_parcel(st, 0.0, 5.0, pt,
                           rng_key=torch.Generator().manual_seed(seed))
            for seed in (5, 5, 6)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0].ln_inpc, runs[2].ln_inpc)
    # no generator: one seeded 0
    zero = TPM.run_parcel(st, 0.0, 5.0, pt,
                          rng_key=torch.Generator().manual_seed(0))
    default = TPM.run_parcel(st, 0.0, 5.0, pt)
    assert all(torch.equal(a, b) for a, b in zip(zero, default))


def _ensemble():
    """A four-member AeroAct ensemble of the emulator's dataset kind, with
    per-member w, r_nuc, sigma_g, N_aer_act and kappa."""
    rng = np.random.default_rng(2)
    n = 4
    T0 = rng.uniform(270.0, 300.0, n)
    p0 = rng.uniform(7e4, 1.02e5, n)
    rho = np.asarray(JTD.air_density(TPS_J, jnp.asarray(T0),
                                     jnp.asarray(p0), 0.0, 0.0, 0.0))
    p_vs = np.asarray(JTD.saturation_vapor_pressure_over_liquid(
        TPS_J, jnp.asarray(T0)))
    q_vap = np.asarray(JTD.p2q(TPS_J, jnp.asarray(T0), jnp.asarray(rho),
                               jnp.asarray(p_vs)))
    N = 10 ** rng.uniform(6.5, 9.0, n)
    z = np.zeros(n)
    ic = dict(S_l=np.full(n, 1.0001), p_air=p0, T=T0, q_vap=q_vap, q_liq=z,
              q_ice=z, N_aer=N, N_liq=z, N_ice=z, ln_inpc=z)
    member = dict(r_nuc=10 ** rng.uniform(-8.2, -6.8, n),
                  aero_sigma_g=rng.uniform(1.4, 2.4, n), N_aer_act=N,
                  w=10 ** rng.uniform(-1.0, 0.7, n),
                  kappa=rng.uniform(0.1, 1.2, n))
    return ic, member


def test_ensemble_member_equals_its_single_run():
    ic, _ = _ensemble()
    _, pt = _params(aerosol_act="AeroAct", aerosol=SULFATE,
                    aero_sigma_g=2.0, condensation_growth="Condensation",
                    const_dt=0.2)
    whole = TPM.run_parcel(_torch_state(ic), 0.0, 4.0, pt)
    for i in range(4):
        one = TPM.run_parcel(_torch_state({k: v[i:i + 1] for k, v in
                                           ic.items()}), 0.0, 4.0, pt)
        for a, b in zip(whole, one):
            np.testing.assert_allclose(a[:, i:i + 1].numpy(), b.numpy(),
                                       rtol=1e-12, atol=0.0)


def test_tensor_parameters_equal_per_member_float_runs():
    """Per-member parameters as (N,) tensors (the port's counterpart of a
    vmap over parameters) give each member its float-parameter run."""
    ic, member = _ensemble()
    _, base = _params(aerosol_act="AeroAct", aerosol=SULFATE,
                      condensation_growth="Condensation", const_dt=0.2)
    tens = {k: torch.tensor(v) for k, v in member.items()}
    pt = dataclasses.replace(
        base, r_nuc=tens["r_nuc"], aero_sigma_g=tens["aero_sigma_g"],
        N_aer_act=tens["N_aer_act"], w=tens["w"],
        aerosol=dataclasses.replace(base.aerosol, kappa=tens["kappa"]))
    whole = TPM.run_parcel(_torch_state(ic), 0.0, 4.0, pt)
    assert bool(torch.isfinite(whole.S_l).all())
    for i in range(4):
        pi = dataclasses.replace(
            base, r_nuc=float(member["r_nuc"][i]),
            aero_sigma_g=float(member["aero_sigma_g"][i]),
            N_aer_act=float(member["N_aer_act"][i]),
            w=float(member["w"][i]), aerosol=dataclasses.replace(
                base.aerosol, kappa=float(member["kappa"][i])))
        one = TPM.run_parcel(_torch_state({k: v[i:i + 1] for k, v in
                                           ic.items()}), 0.0, 4.0, pi)
        for a, b in zip(whole, one):
            np.testing.assert_allclose(a[:, i:i + 1].numpy(), b.numpy(),
                                       rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------------
# box and P3 sandbox
# ---------------------------------------------------------------------------

def test_run_box_matches_jax():
    """examples/box_alpert_knopf_2016.py's deterministic box, cut to 60
    steps."""
    A_aero = 1e-9
    ic = dict(T=256.0, A_sum=1000 * A_aero, N_liq=1000.0, N_ice=0.0)
    want = JBOX.run_box(JBOX.BoxState(**{k: F(v) for k, v in ic.items()}),
                        0.0, 600.0, TPS_J, ILLITE, 0.5 / 60, A_aero, 10.0)
    got = TBOX.run_box(TP.box_state_from_numpy(
        {k: np.asarray(v) for k, v in ic.items()}, device="cpu",
        dtype=torch.float64), 0.0, 600.0, TPS_T, TSP.Illite(), 0.5 / 60,
        A_aero, 10.0)
    assert got.T.shape == (61,)
    _close(got, want, RTOL_STEP, "box")


def test_stochastic_box_step_matches_the_jax_scan_body():
    rng = np.random.default_rng(9)
    Aj = np.sort(rng.lognormal(np.log(1e-9), np.log(10.0), 500))[::-1].copy()
    u = rng.random(500)
    frozen = rng.random(500) < 0.2
    T, dt, cool = 248.5, 10.0, 0.5 / 60
    # the JAX package's scan body (models/box.py:73-86) with given uniforms
    da = 1 - JCO.a_w_ice(TPS_J, F(T))
    J = JIN.ABIFM_J(ILLITE, da)
    P_frz = 1 - jnp.exp(-jnp.asarray(Aj) * J * dt)
    want_frozen = np.asarray((jnp.asarray(u) < P_frz) | jnp.asarray(frozen))
    want_a = np.asarray(jnp.sum(jnp.where(want_frozen, 0.0, Aj)))
    T_new, got_frozen, n_liq, n_ice, a_sum = TBOX._stochastic_step(
        TPS_T, TSP.Illite(), cool, dt, torch.tensor(Aj),
        torch.tensor(T, dtype=torch.float64), torch.tensor(frozen),
        torch.tensor(u))
    np.testing.assert_array_equal(got_frozen.numpy(), want_frozen)
    assert int(n_liq) == int((~want_frozen).sum())
    assert int(n_ice) == int(want_frozen.sum())
    np.testing.assert_allclose(float(a_sum), float(want_a), rtol=1e-12)
    assert float(T_new) == T - cool * dt


def test_run_box_stochastic_shapes_and_bounds():
    Aj = torch.full((400,), 1e-9, dtype=torch.float64)
    T, n_liq, n_ice, a_sum = TBOX.run_box_stochastic(
        248.0, Aj, 0.0, 200.0, TPS_T, TSP.Illite(), 0.05, 1.0,
        torch.Generator().manual_seed(3))
    assert T.shape == n_liq.shape == n_ice.shape == a_sum.shape == (200,)
    assert bool(((n_liq + n_ice) == 400).all())
    assert bool((torch.diff(n_ice) >= 0).all()) and int(n_ice[-1]) > 0
    again = TBOX.run_box_stochastic(
        248.0, Aj, 0.0, 200.0, TPS_T, TSP.Illite(), 0.05, 1.0,
        torch.Generator().manual_seed(3))
    assert torch.equal(n_ice, again[2])


# tests/test_calibration.py's sandbox state
SANDBOX_IC = dict(N_ice=100e6, q_ice=1e-3, q_rim=1e-4, B_rim=1e-4 / 200)
SANDBOX_ENV = dict(T=251.0, p_air=800e2, q_vap=8.1e-4,
                   q_liq=500e3 * 4 / 3 * np.pi * 1e-18 * 1000.0 / 1.2,
                   N_liq=500e3, r_liq=1e-6)


def test_run_p3_sandbox_matches_jax():
    """tests/test_calibration.py's sandbox state."""
    ic, env = SANDBOX_IC, SANDBOX_ENV
    want_traj, want_thr = JSB.run_p3_sandbox(
        JSB.P3SandboxState(**{k: F(v) for k, v in ic.items()}), 0.0, 20.0,
        1.0, JP.p3.parameters_p3(), TPS_J, ILLITE,
        **{k: F(v) for k, v in env.items()})
    got_traj, got_thr = TSB.run_p3_sandbox(
        TP.p3_sandbox_state_from_numpy({k: np.asarray(v) for k, v in
                                        ic.items()}, device="cpu",
                                       dtype=torch.float64),
        0.0, 20.0, 1.0, TP.parameters_p3(), TPS_T, TSP.Illite(),
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in env.items()})
    assert got_traj.N_ice.shape == (20,)
    _close(got_traj, want_traj, RTOL_STEP, "sandbox")
    for g, w in zip(got_thr, want_thr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_STEP)


def test_run_p3_sandbox_float32_matches_jax_without_x64():
    """A float32 sandbox stays float32 (the JAX package's moist gas
    constant is in its default float dtype, float32 without x64) and
    agrees with JAX's float32 program at rtol 1e-6 (measured 2.1e-7 on
    D_gr and D_cr: one or two float32 roundings in the thresholds)."""
    with jax.enable_x64(False):
        f = jnp.float32
        want_traj, want_thr = JSB.run_p3_sandbox(
            JSB.P3SandboxState(**{k: f(v) for k, v in SANDBOX_IC.items()}),
            0.0, 20.0, 1.0, JP.p3.parameters_p3(), TPS_J, ILLITE,
            **{k: f(v) for k, v in SANDBOX_ENV.items()})
        want_traj = type(want_traj)(*(np.asarray(v) for v in want_traj))
        want_thr = [np.asarray(v) for v in want_thr]
    got_traj, got_thr = TSB.run_p3_sandbox(
        TP.p3_sandbox_state_from_numpy({k: np.asarray(v) for k, v in
                                        SANDBOX_IC.items()}, device="cpu",
                                       dtype=torch.float32),
        0.0, 20.0, 1.0, TP.parameters_p3(), TPS_T, TSP.Illite(),
        **{k: torch.tensor(v, dtype=torch.float32)
           for k, v in SANDBOX_ENV.items()})
    for g, w in zip((*got_traj, *got_thr), (*want_traj, *want_thr)):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
