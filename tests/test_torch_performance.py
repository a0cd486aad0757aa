"""Performance-regression budgets of the port on the CPU (the port of
tests/test_performance.py, reference test/performance_tests.jl).

Each entry point the port has goes through
:func:`cloudmicrophysics_tpu_torch.perf.bench_press` on the same 4096-point
float32 batches as the JAX suite, on the CPU: (a) a latency budget on the
best of 10 calls, (b) no kernel library built or loaded by a repeat call,
(c) no float output wider than the float inputs.

Budgets are CPU wall times of eager PyTorch on one intra-op thread, at
least 20 times the slowest of several best-of-10 times measured on a
shared 8-core machine (where one function's best time varied up to
threefold between runs), and never under 5 ms, so that several test
workers sharing the cores do not make them flaky: they catch a catastrophic regression (per-element Python loops, an
accidental float64 promotion), not drift. The card's speed is tracked by
``chip_smoke.py`` and the roofline. The budgets of aerosol activation,
``het_ice_nucleation``, the 2M reflectivity and effective radius, the
Liu-Hallett radius, H2SO4 nucleation and one parcel step are set by the
same rule (``TestZeroDBudgets``).
"""

import pytest
import torch

import cloudmicrophysics_tpu_torch.parameters as P
from cloudmicrophysics_tpu_torch.models.tendencies import (
    bulk_tendencies_0m,
    bulk_tendencies_1m,
    bulk_tendencies_2m,
)
from cloudmicrophysics_tpu_torch.ops import m1 as CM1
from cloudmicrophysics_tpu_torch.perf import bench_press
from cloudmicrophysics_tpu_torch.utils.special import gamma_inc, gamma_inc_inv

TPS = P.ThermodynamicsParameters()
N = 4096
F = torch.float32
MS = 1e6  # ns per ms


def full(v, n=N):
    return torch.full((n,), v, dtype=F)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Time on one intra-op thread: 4096-point batches gain nothing from
    more, and several test workers each spinning up a full thread pool on
    shared cores slow one another down by up to a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TestNumericsBudgets:
    def test_gamma_inc(self):
        r = bench_press(gamma_inc, (full(2.5), full(1.2)), 100 * MS)
        assert r.n_traces == 1

    def test_gamma_inc_inv(self):
        bench_press(gamma_inc_inv, (full(2.5), full(0.3), full(0.7)),
                    1200 * MS)


class TestSchemeBudgets:
    def test_bulk_0m(self):
        mp = P.microphysics_0m_params()
        bench_press(
            lambda T, ql, qi: bulk_tendencies_0m(mp, TPS, T, ql, qi),
            (full(278.0), full(1e-3), full(1e-4)), 5 * MS, name="bulk_0m")

    def test_bulk_1m(self):
        mp = P.microphysics_1m_params()
        bench_press(
            lambda rho, T, qt, ql, qi, qr, qs: bulk_tendencies_1m(
                mp, TPS, rho, T, qt, ql, qi, qr, qs),
            (full(1.1), full(278.0), full(5e-3), full(1e-3), full(1e-4),
             full(5e-4), full(2e-4)), 120 * MS, name="bulk_1m")

    def test_rain_terminal_velocity_chen(self):
        mp = P.microphysics_1m_params()
        tv = P.terminal_velocity_params()
        bench_press(
            lambda rho, q: CM1.terminal_velocity(
                mp.precip.rain, tv.chen2022.rain, rho, q),
            (full(1.1), full(1e-3)), 20 * MS, name="vt_rain_chen2022")

    def test_bulk_2m_warm(self):
        mp = P.microphysics_2m_params()
        bench_press(
            lambda rho, T, qt, ql, nl, qr, nr: bulk_tendencies_2m(
                mp, TPS, rho, T, qt, ql, nl, qr, nr),
            (full(1.1), full(288.0), full(6e-3), full(1e-3), full(9e7),
             full(5e-4), full(9e5)), 120 * MS, name="bulk_2m_warm")

    @pytest.mark.slow
    def test_bulk_2m_p3(self):
        # the 2-D collision quadrature dominates; 512-point batch
        mp = P.microphysics_2m_params(with_ice=True)
        n = 512
        bench_press(
            lambda rho, T, qt, ql, nl, qr, nr, qi, ni, qrim, brim:
            bulk_tendencies_2m(mp, TPS, rho, T, qt, ql, nl, qr, nr,
                               qi, ni, qrim, brim),
            (full(1.1, n), full(263.0, n), full(4e-3, n), full(5e-4, n),
             full(9e7, n), full(2e-4, n), full(9e5, n), full(1e-4, n),
             full(9e4, n), full(3e-5, n), full(3e-5 / 400, n)), 3000 * MS,
            name="bulk_2m_p3")


class TestP3Budgets:
    """P3 hot entry points (reference test/performance_tests.jl:200-280:
    state construction, shape solve, terminal velocities)."""

    @staticmethod
    def _state(quadrature_order=16):
        from cloudmicrophysics_tpu_torch.ops import p3 as P3

        mp = P.microphysics_2m_params(with_ice=True,
                                      quadrature_order=quadrature_order)
        st = P3.state_from_prognostic(
            mp.ice.scheme, full(1e-4 * 1.1), full(9e4 * 1.1),
            full(3e-5 * 1.1), full(3e-5 / 400 * 1.1))
        return mp, st, P3.get_distribution_loglambda(st)

    def test_p3_state_ctor(self):
        from cloudmicrophysics_tpu_torch.ops import p3 as P3

        mp = P.microphysics_2m_params(with_ice=True)
        bench_press(
            lambda L, N, Lr, Br: P3.state_from_prognostic(
                mp.ice.scheme, L, N, Lr, Br),
            (full(1e-4), full(9e4), full(3e-5), full(3e-5 / 400)), 30 * MS,
            name="p3_state_ctor")

    def test_p3_shape_solver(self):
        from cloudmicrophysics_tpu_torch.ops import p3 as P3

        mp, _, _ = self._state()
        bench_press(
            lambda L, N: P3.get_distribution_loglambda(
                P3.state_from_prognostic(mp.ice.scheme, L, N,
                                         full(3e-5), full(3e-5 / 400))),
            (full(1e-4), full(9e4)), 5500 * MS, name="p3_shape_solver")

    def test_p3_terminal_velocities(self):
        from cloudmicrophysics_tpu_torch.ops import p3 as P3

        mp, st, ll = self._state()
        vel = mp.ice.terminal_velocity
        bench_press(
            lambda rho, ll: P3.ice_terminal_velocity_number_weighted(
                vel, rho, st, ll, quad=mp.ice.quad),
            (full(1.1), ll), 2000 * MS, name="p3_vt_number")
        bench_press(
            lambda rho, ll: P3.ice_terminal_velocity_mass_weighted(
                vel, rho, st, ll, quad=mp.ice.quad),
            (full(1.1), ll), 2000 * MS, name="p3_vt_mass")


class TestMoreSchemeBudgets:
    """2M self-collection and breakup (reference
    test/performance_tests.jl:120-180)."""

    def test_rain_self_collection_and_breakup(self):
        from cloudmicrophysics_tpu_torch.ops import m2 as CM2

        sb = P.microphysics_2m_params().warm_rain.seifert_beheng
        bench_press(
            lambda q, rho, N: CM2.rain_self_collection_and_breakup(
                sb, q, rho, N),
            (full(5e-4), full(1.1), full(9e5)), 20 * MS,
            name="rain_sc_breakup")


class TestColumnBudget:
    def test_step_column_1m(self):
        from cloudmicrophysics_tpu_torch.models.column import (
            ColumnState,
            step_column_1m,
        )

        mp = P.microphysics_1m_params()
        tv = P.terminal_velocity_params()
        ncol, nlev = 128, 32

        def c(v):
            return torch.full((ncol, nlev), v, dtype=F)

        state = ColumnState(rho=c(1.1), T=c(278.0), q_tot=c(5e-3),
                            q_lcl=c(1e-3), q_icl=c(1e-4), q_rai=c(1e-4),
                            q_sno=c(1e-5))
        bench_press(
            lambda s: step_column_1m(s, mp, TPS, tv, 1.0, 100.0),
            (state,), 150 * MS, name="step_column_1m")


class TestBroadenedBudgets:
    """The JAX suite's round-5 breadth (reference
    test/performance_tests.jl:80-356): melt, self-collection, collisions,
    Bigg freezing, Frostenberg INPC, non-equilibrium rates, distribution
    quantiles and the 1M accretion/evaporation/melt family."""

    _p3 = staticmethod(lambda: TestP3Budgets._state(quadrature_order=8))

    def test_ice_melt(self):
        from cloudmicrophysics_tpu_torch.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda T, rho, ll: P3P.ice_melt(
                mp.ice.terminal_velocity, mp.warm_rain.air_properties,
                TPS, T, rho, st, ll, quad=mp.ice.quad),
            (full(275.0), full(1.1), ll), 1500 * MS, name="ice_melt")

    def test_ice_self_collection(self):
        from cloudmicrophysics_tpu_torch.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda rho, ll: P3P.ice_self_collection(
                st, ll, mp.ice.terminal_velocity, rho, quad=mp.ice.quad),
            (full(1.1), ll), 3000 * MS, name="ice_self_collection")

    def test_collision_sources(self):
        from cloudmicrophysics_tpu_torch.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda ql, nl, qr, nr, rho, T, ll:
            P3P.bulk_liquid_ice_collision_sources(
                st, ll, mp.ice.cloud_pdf, mp.ice.rain_pdf, ql * rho,
                nl * rho, qr * rho, nr * rho,
                mp.warm_rain.air_properties, TPS,
                mp.ice.terminal_velocity, rho, T, quad=mp.ice.quad),
            (full(1e-3), full(9e7), full(5e-4), full(9e5), full(1.1),
             full(263.0), ll), 3500 * MS, name="collision_sources")

    def test_bigg_freezing(self):
        from cloudmicrophysics_tpu_torch.ops import ice_nucleation as CMI

        mp = P.microphysics_2m_params(with_ice=True)
        bench_press(
            lambda q, rho, N, T: CMI.liquid_freezing_rate_cloud(
                mp.ice.rain_freezing, mp.ice.cloud_pdf, TPS, q, rho, N, T),
            (full(1e-3), full(1.1), full(1e8), full(260.0)), 15 * MS,
            name="bigg_freezing_cloud")
        bench_press(
            lambda q, rho, N, T: CMI.liquid_freezing_rate_rain(
                mp.ice.rain_freezing, mp.ice.rain_pdf, TPS, q, rho, N, T),
            (full(5e-4), full(1.1), full(1e6), full(260.0)), 15 * MS,
            name="bigg_freezing_rain")

    def test_frostenberg_inpc(self):
        from cloudmicrophysics_tpu_torch.ops import ice_nucleation as CMI

        fp = P.Frostenberg2023()
        bench_press(lambda T: CMI.INP_concentration_mean(fp, T),
                    (full(253.0),), 5 * MS, name="inpc_mean")
        bench_press(
            lambda inpc, T: CMI.INP_concentration_frequency(fp, inpc, T),
            (full(1e4), full(253.0)), 5 * MS, name="inpc_frequency")

    def test_noneq_rates(self):
        from cloudmicrophysics_tpu_torch.ops import noneq as NE
        from cloudmicrophysics_tpu_torch.ops.states import (
            MicroState,
            ThermoState,
        )

        mp = P.microphysics_1m_params()
        mic = MicroState(q_tot=full(6e-3), q_lcl=full(1e-3),
                         q_icl=full(1e-4), q_rai=full(1e-4),
                         q_sno=full(1e-5))
        th = ThermoState(rho=full(1.1), T=full(268.0))
        bench_press(lambda mic, th: NE.conv_q_vap_to_q_lcl(mp, TPS, mic, th),
                    (mic, th), 10 * MS, name="noneq_cond_evap")
        bench_press(lambda mic, th: NE.conv_q_vap_to_q_icl(mp, TPS, mic, th),
                    (mic, th), 10 * MS, name="noneq_dep_subl")

    def test_tau_relax_frostenberg(self):
        from cloudmicrophysics_tpu_torch.ops import noneq as NE

        mp = P.microphysics_1m_params()
        aps = P.AirProperties()
        bench_press(
            lambda q, T: NE.tau_relax_frostenberg(
                mp.cloud.ice, aps, P.Frostenberg2023(), q, T),
            (full(1e-4), full(253.0)), 5 * MS, name="tau_relax_frostenberg")

    def test_distribution_quantiles(self):
        from cloudmicrophysics_tpu_torch.utils import distributions as DT

        bench_press(
            lambda nu, B, Y: DT.generalized_gamma_quantile(nu, full(1.0),
                                                           B, Y),
            (full(2.5), full(1e4), full(0.999)), 1200 * MS,
            name="gen_gamma_quantile")
        bench_press(lambda Dm, Y: DT.exponential_quantile(Dm, Y),
                    (full(1e-4), full(0.999)), 5 * MS,
                    name="exponential_quantile")

    def test_1m_accretion_family(self):
        from cloudmicrophysics_tpu_torch.ops import m1 as M1
        from cloudmicrophysics_tpu_torch.ops.states import (
            MicroState,
            ThermoState,
        )

        mp = P.microphysics_1m_params()
        mic = MicroState(q_tot=full(6e-3), q_lcl=full(1e-3),
                         q_icl=full(1e-4), q_rai=full(5e-4),
                         q_sno=full(5e-4))
        th = ThermoState(rho=full(1.1), T=full(268.0))
        for fn, budget in ((M1.accretion_cloud_liquid_rain, 15),
                           (M1.accretion_cloud_liquid_snow, 15),
                           (M1.accretion_cloud_ice_snow, 15),
                           (M1.accretion_snow_rain, 30),
                           (M1.conv_q_rai_to_q_vap, 25),
                           (M1.conv_q_sno_to_q_vap, 20),
                           (M1.conv_q_sno_to_q_rai, 15)):
            bench_press(lambda mic, th, fn=fn: fn(mp, TPS, mic, th),
                        (mic, th), budget * MS, name=fn.__name__)


class TestZeroDBudgets:
    """The JAX suite's budgets of the aerosol, nucleation, diagnostics and
    parcel entry points (``tests/test_performance.py:101, 172, 197, 212,
    351, 372``)."""

    def test_aerosol_activation(self):
        from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA
        from cloudmicrophysics_tpu_torch.parameters.aerosol import (
            AerosolActivationParameters,
            AerosolDistribution,
            ModeKappa,
        )

        ap = AerosolActivationParameters()
        aip = P.AirProperties()
        mode = ModeKappa(r_dry=5e-8, stdev=2.0, N=1e8, vol_mix_ratio=(1.0,),
                         mass_mix_ratio=(1.0,), molar_mass=(0.13214,),
                         kappa=(0.53,))
        ad = AerosolDistribution(modes=(mode,))
        bench_press(
            lambda T, p, w, qt: AA.total_N_activated(
                ap, ad, aip, TPS, T, p, w, qt, 0.0, 0.0),
            (full(285.0), full(9e4), full(0.5), full(8e-3)), 35 * MS,
            name="arg_activation")

    def test_het_ice_nucleation(self):
        from cloudmicrophysics_tpu_torch.ops import p3_processes as P3P
        from cloudmicrophysics_tpu_torch.parameters.aerosol_species import (
            Illite,
        )

        bench_press(
            lambda ql, Nl, RH, T, rho: P3P.het_ice_nucleation(
                Illite(), TPS, ql, Nl, RH, T, rho),
            (full(1e-4), full(1e8), full(1.0), full(251.0), full(1.1)),
            6 * MS, name="het_ice_nucleation")

    def test_reflectivity_and_r_eff_2m(self):
        from cloudmicrophysics_tpu_torch.ops import diagnostics as CMD

        sb = P.microphysics_2m_params().warm_rain.seifert_beheng
        args = (full(1e-3), full(5e-4), full(9e7), full(9e5), full(1.1))
        bench_press(
            lambda ql, qr, Nl, Nr, rho: CMD.radar_reflectivity_2m(
                sb, ql, qr, Nl, Nr, rho), args, 15 * MS,
            name="radar_reflectivity_2m")
        bench_press(
            lambda ql, qr, Nl, Nr, rho: CMD.effective_radius_2m(
                sb, ql, qr, Nl, Nr, rho), args, 15 * MS,
            name="effective_radius_2m")

    def test_h2so4_nucleation_rate(self):
        from cloudmicrophysics_tpu_torch.ops import nucleation as NPF

        mn = P.H2SO4NucleationParameters()
        bench_press(
            lambda c, T: NPF.h2so4_nucleation_rate(
                c, full(1.0), full(1.0), T, mn),
            (full(1e6), full(208.0)), 12 * MS,
            name="h2so4_nucleation_rate")

    def test_liu_hallett_r_eff(self):
        from cloudmicrophysics_tpu_torch.ops import diagnostics as CMD

        bench_press(
            lambda rho, ql, Nl: CMD.effective_radius_liu_hallet_97(
                1000.0, rho, ql, Nl),
            (full(1.1), full(1e-3), full(1e8)), 5 * MS,
            name="liu_hallett_r_eff")

    def test_parcel_single_step(self):
        from cloudmicrophysics_tpu_torch.models import parcel as PM

        params = PM.parcel_params(condensation_growth="Condensation",
                                  const_dt=0.1, w=1.0)
        y = PM.ParcelState(S_l=full(1.02), p_air=full(8e4), T=full(278.0),
                           q_vap=full(6e-3), q_liq=full(1e-3),
                           q_ice=full(0.0), N_aer=full(1e8),
                           N_liq=full(1e8), N_ice=full(0.0),
                           ln_inpc=full(0.0))
        bench_press(
            lambda y: PM.parcel_tendencies(params, y, 0.0, full(0.0)),
            (y,), 40 * MS, name="parcel_single_step")
