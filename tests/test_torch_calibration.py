"""The port's calibration (EKI, UKI, the ABIFM parcel workflow, AIDA) and
data artifacts against the JAX package, on the CPU.

Tolerances:

* EKI on a linear map, JAX's random draws injected in place of the
  port's (:func:`models.calibration._standard_normal`): float64, rtol
  1e-10 on the mean and the misfits.
* UKI on a linear map (no draws): rtol 1e-10 on the mean and the misfits.
* The misfits of both also within 1e-12 of the first misfit (measured
  6.5e-14 for EKI, 1.6e-16 for UKI): once the fit has converged, a misfit
  is the square of a residual ~1e-4 (EKI) or ~1e-14 (UKI) that is a
  difference of nearly equal numbers, whose rounding in either package
  sets its relative error.
* The final ensembles of both at rtol 1e-8 (measured 2.4e-10 for EKI,
  3.8e-9 for UKI). With observation noise 1e-6 the members sit ~1e-4
  (EKI) and ~1e-5 (UKI) from their mean: the EKI spread passes through
  the inverse of ``C_gg + Gamma``, whose condition number multiplies the
  packages' different rounding of ``solve``, and the UKI sigma points are
  the Cholesky factor of the posterior covariance ``C_hat - K C_ty^T``, a
  difference of nearly equal terms.
* UKI through ``calibrate_abifm`` (a 40 s parcel window, 3 iterations):
  rtol 1e-6 on ``theta`` and ``errors``. The forward map is the parcel,
  which the port runs as one ensemble and JAX as a ``vmap``; on the CPU
  their transcendentals round apart by ~1e-15, which the parcel's 40
  steps and the Kalman gain grow to ~1e-12.
* The port's own EKI perfect-model recovery and the synthetic AIDA
  chamber workflow are held to the gates of ``tests/test_calibration.py``.
* AIDA parsing and observations are numpy in both packages: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu.models import aida as JAIDA
from cloudmicrophysics_tpu.models import calibration as JCAL
from cloudmicrophysics_tpu.models import parcel as JPM
from cloudmicrophysics_tpu.ops import thermo as JTD
from cloudmicrophysics_tpu.parameters import ThermodynamicsParameters
from cloudmicrophysics_tpu.parameters.aerosol_species import Illite as JIllite
from cloudmicrophysics_tpu_torch.models import aida as TAIDA
from cloudmicrophysics_tpu_torch.models import calibration as TCAL
from cloudmicrophysics_tpu_torch.models import parcel as TPM
from cloudmicrophysics_tpu_torch.parameters.aerosol_species import (
    Illite as TIllite,
)

TPS = ThermodynamicsParameters()
F = jnp.float64
CPU = "cpu"
RTOL_ENSEMBLE = 1e-8
ATOL_MISFIT = 1e-12
KWARGS = dict(heterogeneous="ABIFM", condensation_growth="Condensation",
              const_dt=1.0, w=0.5)


def _linear(seed):
    A = np.random.default_rng(seed).normal(size=(6, 2))
    return A, A @ np.array([2.0, -1.5])


def _jax_draws(n_ens, n_params, n_obs, n_iterations, seed=24):
    """The standard normals JAX's ``eki_calibrate`` draws with its default
    key: the prior ensemble's, then each iteration's (the normals of its
    ``multivariate_normal``, Cholesky method)."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, (n_ens, n_params), jnp.float64)]
    for _ in range(n_iterations):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, (n_ens, n_obs), jnp.float64))
    return [np.asarray(d) for d in draws]


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_errors(got, want):
    # a converged misfit is the square of a difference of nearly equal
    # numbers: its floor is the packages' rounding of the prediction
    _close(got, want, 1e-10, ATOL_MISFIT * float(np.asarray(want)[0]))


class TestEKI:
    def test_linear_map_with_jax_draws(self, monkeypatch):
        A, y = _linear(0)
        cov = np.eye(6) * 1e-6
        want = JCAL.eki_calibrate(lambda t: t @ A.T, [0.0, 0.0], [2.0, 2.0],
                                  y, cov, n_ensemble=30, n_iterations=10)
        draws = iter(_jax_draws(30, 2, 6, 10))
        monkeypatch.setattr(
            TCAL, "_standard_normal",
            lambda gen, shape, device: torch.tensor(next(draws),
                                                    device=device))
        At = torch.as_tensor(A)
        got = TCAL.eki_calibrate(lambda t: t @ At.T, [0.0, 0.0], [2.0, 2.0],
                                 y, cov, n_ensemble=30, n_iterations=10,
                                 device=CPU)
        assert next(draws, None) is None
        assert got.theta.dtype == torch.float64 and got.iterations == 10
        _close(got.theta, want.theta, 1e-10)
        _close_errors(got.errors, want.errors)
        _close(got.ensemble, want.ensemble, RTOL_ENSEMBLE)

    def test_linear_recovery_with_its_own_draws(self):
        # tests/test_calibration.py::TestEKI::test_linear_recovery's gate
        A, y = _linear(0)
        At = torch.as_tensor(A)
        res = TCAL.eki_calibrate(lambda t: t @ At.T, [0.0, 0.0], [2.0, 2.0],
                                 y, np.eye(6) * 1e-6, n_ensemble=30,
                                 n_iterations=10, device=CPU)
        np.testing.assert_allclose(res.theta.numpy(), [2.0, -1.5], atol=0.05)
        assert float(res.errors[-1]) < float(res.errors[0])
        # a seeded generator reproduces its fit
        gen = torch.Generator().manual_seed(24)
        again = TCAL.eki_calibrate(lambda t: t @ At.T, [0.0, 0.0],
                                   [2.0, 2.0], y, np.eye(6) * 1e-6,
                                   n_ensemble=30, n_iterations=10,
                                   rng_key=gen, device=CPU)
        assert torch.equal(again.theta, res.theta)


class TestUKI:
    def test_linear_map(self):
        A, y = _linear(3)
        want = JCAL.uki_calibrate(lambda t: t @ A.T, [0.0, 0.0], [2.0, 2.0],
                                  y, np.eye(6) * 1e-6, n_iterations=15)
        At = torch.as_tensor(A)
        got = TCAL.uki_calibrate(lambda t: t @ At.T, [0.0, 0.0], [2.0, 2.0],
                                 y, np.eye(6) * 1e-6, n_iterations=15,
                                 device=CPU)
        assert got.ensemble.shape == (2, 5)
        _close(got.theta, want.theta, 1e-10)
        _close_errors(got.errors, want.errors)
        _close(got.ensemble, want.ensemble, RTOL_ENSEMBLE)

    def test_abifm_route(self):
        ic_j, ic_t = _chamber_ic()
        y_obs = _observed(ic_j, 40.0)
        kw = dict(noise_std=0.02, prior_mean=(50.0, -9.0),
                  prior_std=(8.0, 2.0), n_iterations=3, method="UKI")
        want = JCAL.calibrate_abifm(ic_j, 40.0, KWARGS, y_obs, **kw)
        got = TCAL.calibrate_abifm(ic_t, 40.0, KWARGS, y_obs, device=CPU,
                                   **kw)
        _close(got.theta, want.theta, 1e-6)
        _close(got.errors, want.errors, 1e-6)
        assert float(got.errors[-1]) <= float(got.errors[0])


def _chamber_ic(T0=251.0, p0=80000.0, Nl=1e8, r0=1e-6):
    """tests/test_calibration.py's chamber state, as a JAX ParcelState and
    as the port's float numbers."""
    e = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
    md = (p0 - e) / TPS.R_d / T0
    mv = e / TPS.R_v / T0
    ml = Nl * 4 / 3 * np.pi * 1000 * r0**3
    values = dict(S_l=1.0, p_air=p0, T=T0, q_vap=mv / (md + mv + ml),
                  q_liq=ml / (md + mv + ml), q_ice=0.0, N_aer=0.0,
                  N_liq=Nl, N_ice=0.0, ln_inpc=0.0)
    return (JPM.ParcelState(**{k: F(v) for k, v in values.items()}),
            TPM.ParcelState(**values))


def _observed(ic_j, t_end, m=54.48, c=-10.67):
    """Frozen fractions at 5 times of the JAX parcel with (m, c)."""
    aerosol = dataclasses.replace(JIllite(), ABIFM_m=m, ABIFM_c=c)
    traj = JPM.run_parcel(ic_j, 0.0, t_end,
                          JPM.parcel_params(aerosol=aerosol, **KWARGS))
    frozen = np.asarray(traj.N_ice / np.maximum(
        np.asarray(traj.N_liq + traj.N_ice), 1.0))
    return frozen[np.linspace(0, len(frozen) - 1, 5).astype(int)]


def _frozen_torch(ic_t, t_end, m, c):
    aerosol = dataclasses.replace(TIllite(), ABIFM_m=m, ABIFM_c=c)
    ic = TPM.ParcelState(*(torch.tensor(float(v), dtype=torch.float64)
                           for v in ic_t))
    traj = TPM.run_parcel(ic, 0.0, t_end,
                          TPM.parcel_params(aerosol=aerosol, **KWARGS))
    frozen = (traj.N_ice / torch.clamp(traj.N_liq + traj.N_ice, min=1.0)
              ).numpy()
    return frozen[np.linspace(0, len(frozen) - 1, 5).astype(int)]


def test_abifm_perfect_model_recovery():
    # tests/test_calibration.py::TestEKI's perfect-model gate, on the
    # port's own draws
    ic_j, ic_t = _chamber_ic()
    y_obs = _frozen_torch(ic_t, 60.0, 54.48, -10.67)
    assert y_obs[-1] > 0
    res = TCAL.calibrate_abifm(
        ic_t, 60.0, KWARGS, y_obs, noise_std=0.02, prior_mean=(50.0, -9.0),
        prior_std=(8.0, 2.0), n_ensemble=20, n_iterations=6, device=CPU)
    assert res.ensemble.shape == (2, 20)
    fit = _frozen_torch(ic_t, 60.0, float(res.theta[0]), float(res.theta[1]))
    np.testing.assert_allclose(fit, y_obs, atol=0.05)
    assert float(res.errors[-1]) <= float(res.errors[0])


class TestArtifacts:
    def test_missing_artifact_error(self, tmp_path, monkeypatch):
        from cloudmicrophysics_tpu_torch.utils import (
            AIDA_ice_nucleation,
            ArtifactMissingError,
            artifacts_dir,
        )

        monkeypatch.setenv("CMT_ARTIFACTS_DIR", str(tmp_path))
        assert artifacts_dir() == tmp_path
        with pytest.raises(ArtifactMissingError, match="no network egress"):
            AIDA_ice_nucleation("in05_17_aida.edf")
        d = tmp_path / "AIDA_ice_nucleation"
        d.mkdir()
        (d / "in05_17_aida.edf").write_text("data")
        assert AIDA_ice_nucleation("in05_17_aida.edf").read_text() == "data"
        assert issubclass(ArtifactMissingError, FileNotFoundError)


def _synthetic_edf(tmp_path, ic_j, e0):
    """tests/test_calibration.py::TestAIDA's file: 225 header lines, then
    the JAX parcel's 121 seconds."""
    params = JPM.parcel_params(aerosol=JIllite(), **KWARGS)
    traj = JPM.run_parcel(ic_j, 0.0, 120.0, params)
    lines = ["# header"] * 225
    for i in range(121):
        lines.append(
            f"{float(i):.1f} {float(traj.p_air[i]) / 100:.3f} "
            f"{float(traj.T[i]):.3f} {e0:.3f} 0 "
            f"{float(traj.N_ice[i]) / 1e6:.6e}")
    edf = tmp_path / "synth.edf"
    edf.write_text("\n".join(lines) + "\n")
    return edf


class TestAIDA:
    def test_parsing_and_observations_match(self, tmp_path):
        ic_j, _ = _chamber_ic()
        e0 = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(251.0)))
        edf = _synthetic_edf(tmp_path, ic_j, e0)
        pj, pt = JAIDA.unpack_aida_edf(edf), TAIDA.unpack_aida_edf(edf)
        assert type(pt).__name__ == "AIDAProfile" and pt._fields == pj._fields
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(a, b)
        x = np.random.default_rng(0).normal(size=97)
        for n in (1, 5, 50, 200):
            np.testing.assert_array_equal(TAIDA.moving_average(x, n),
                                          JAIDA.moving_average(x, n))
        for window in ((0.0, 120.0), (10.0, 90.0)):
            np.testing.assert_array_equal(
                TAIDA.aida_observations(pt, *window, 1e8, n_obs=7),
                JAIDA.aida_observations(pj, *window, 1e8, n_obs=7))

    def test_synthetic_chamber_calibration(self, tmp_path):
        # tests/test_calibration.py::TestAIDA's gate on the port's own EKI
        ic_j, _ = _chamber_ic()
        e0 = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(251.0)))
        prof = TAIDA.unpack_aida_edf(_synthetic_edf(tmp_path, ic_j, e0))
        assert prof.P[0] == pytest.approx(80000.0)
        obs = TAIDA.aida_observations(prof, 0.0, 120.0, 1e8, n_obs=5)
        assert obs[-1] > obs[0] >= 0
        res = TAIDA.calibrate_abifm_aida(
            prof, 0.0, 120.0, 1e8, 1e8, 1e-6, noise_std=0.02,
            prior_mean=(50.0, -9.0), prior_std=(8.0, 2.0), n_ensemble=20,
            n_iterations=6, device=CPU)
        assert res.errors.dtype == torch.float64
        assert float(res.errors[-1]) < 1e-3 * float(res.errors[0])
