"""Ensemble Kalman Inversion (EKI) and Unscented Kalman Inversion (UKI)
calibration over the parcel model.

Port of ``cloudmicrophysics_tpu/models/calibration.py`` (reference
``papers/ice_nucleation_2024/calibration.jl:294-410``): the forward map is
the parcel run as one ensemble, every member in the same tensors, and the
Kalman update is a few small float64 matrix products on the device of the
work (the GPU unless ``device="cpu"`` is asked for).

Provides a generic :func:`eki_calibrate` and :func:`uki_calibrate` plus the
ABIFM (m, c) perfect-model recovery workflow of the reference tests
(``test/ice_nucleation_calibration.jl``). Random draws come from a
``torch.Generator`` on the work's device (seeded 24 when none is given),
so the two packages draw different streams; both draws go through
:func:`_standard_normal`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["EKIResult", "eki_calibrate", "uki_calibrate", "calibrate_abifm"]

F64 = torch.float64


class EKIResult(NamedTuple):
    theta: torch.Tensor      # calibrated parameter means, shape (n_params,)
    ensemble: torch.Tensor   # final ensemble, shape (n_params, n_ens)
    errors: torch.Tensor     # data misfit per iteration
    iterations: int


def _standard_normal(generator: torch.Generator, shape: tuple,
                     device: torch.device) -> torch.Tensor:
    """Float64 standard normals of ``shape`` from ``generator``: the prior
    ensemble's draws and each iteration's observation perturbations."""
    return torch.randn(shape, generator=generator, dtype=F64, device=device)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


def eki_calibrate(
    forward_map: Callable[[torch.Tensor], torch.Tensor],
    prior_mean,
    prior_std,
    y_obs,
    noise_cov,
    n_ensemble: int = 25,
    n_iterations: int = 10,
    rng_key: torch.Generator | None = None,
    device: torch.device | str = "cuda",
) -> EKIResult:
    """Basic Ensemble Kalman Inversion.

    ``forward_map(theta_batch)`` maps a ``(n_ens, n_params)`` float64
    parameter batch on ``device`` to ``(n_ens, n_obs)`` predictions,
    typically one ensemble run of a model.

    The update is the standard EKI step
    ``theta <- theta + C_tg (C_gg + Gamma)^-1 (y - g)`` with sample
    covariances over the ensemble; the observations are perturbed with
    draws of ``N(0, noise_cov)``, standard normals times the Cholesky
    factor of ``noise_cov``. ``rng_key`` is a ``torch.Generator`` on
    ``device`` (one seeded 24 when none is given). Each iteration's misfit
    is read on the host.
    """
    device = torch.device(device)
    if rng_key is None:
        rng_key = torch.Generator(device=device).manual_seed(24)
    prior_mean = _f64(prior_mean, device)
    prior_std = _f64(prior_std, device)
    y_obs = _f64(y_obs, device)
    noise_cov = _f64(noise_cov, device)
    n_params = prior_mean.shape[0]
    n_obs = y_obs.shape[0]
    noise_factor = torch.linalg.cholesky(noise_cov)
    eye = torch.eye(n_obs, dtype=F64, device=device)

    theta = prior_mean[None, :] + prior_std[None, :] * _standard_normal(
        rng_key, (n_ensemble, n_params), device)

    errors = []
    for _ in range(n_iterations):
        g = _f64(forward_map(theta), device)          # (n_ens, n_obs)
        g_mean = torch.mean(g, dim=0)
        t_mean = torch.mean(theta, dim=0)
        dg = g - g_mean
        dt = theta - t_mean
        C_tg = dt.T @ dg / (n_ensemble - 1)          # (n_params, n_obs)
        C_gg = dg.T @ dg / (n_ensemble - 1)          # (n_obs, n_obs)
        K = C_tg @ torch.linalg.solve(C_gg + noise_cov, eye)
        # perturbed observations
        z = _standard_normal(rng_key, (n_ensemble, n_obs), device)
        y_pert = y_obs[None, :] + z @ noise_factor.T
        theta = theta + (y_pert - g) @ K.T
        errors.append(float(torch.sum((g_mean - y_obs) ** 2)))

    return EKIResult(theta=torch.mean(theta, dim=0), ensemble=theta.T,
                     errors=_f64(errors, device), iterations=n_iterations)


def uki_calibrate(
    forward_map: Callable[[torch.Tensor], torch.Tensor],
    prior_mean,
    prior_std,
    y_obs,
    noise_cov,
    n_iterations: int = 25,
    alpha_reg: float = 1.0,
    device: torch.device | str = "cuda",
) -> EKIResult:
    """Unscented Kalman Inversion (Huang, Schneider & Stuart 2022), the
    reference's second calibration mode
    (papers/ice_nucleation_2024/calibration.jl:364-410, ``EKP.Unscented``).

    Deterministic sigma-point ensemble (2p+1 members for p parameters),
    no sampling noise; ``forward_map`` has the same batched contract as
    :func:`eki_calibrate`. With ``alpha_reg < 1`` the prior regularizes
    each prediction step."""
    device = torch.device(device)
    prior_mean = _f64(prior_mean, device)
    prior_std = _f64(prior_std, device)
    y_obs = _f64(y_obs, device)
    Gamma = _f64(noise_cov, device)
    p = prior_mean.shape[0]

    r = prior_mean
    C0 = torch.diag(prior_std**2)
    m, C = prior_mean, C0
    Sigma_nu = 2.0 * Gamma
    Sigma_omega = max(2.0 - alpha_reg**2, 0.0) * C0

    # unscented weights (kappa = 0, standard symmetric set, a = 1/sqrt(p+l))
    lam = 1.0
    w0 = lam / (p + lam)
    wj = 1.0 / (2 * (p + lam))
    weights = _f64([w0] + [wj] * (2 * p), device)
    eye_p = torch.eye(p, dtype=F64, device=device)
    eye_y = torch.eye(y_obs.shape[0], dtype=F64, device=device)

    errors = []
    theta = None
    for _ in range(n_iterations):
        # prediction
        m_hat = r + alpha_reg * (m - r)
        C_hat = alpha_reg**2 * C + Sigma_omega
        # sigma points: m_hat, m_hat +- sqrt((p+lam) C_hat) columns
        L = torch.linalg.cholesky((p + lam) * C_hat + 1e-12 * eye_p)
        theta = torch.cat(
            [m_hat[None, :], m_hat[None, :] + L.T, m_hat[None, :] - L.T],
            dim=0)                                      # (2p+1, p)
        g = _f64(forward_map(theta), device)           # (2p+1, n_obs)
        y_hat = weights @ g
        dth = theta - m_hat
        dg = g - y_hat
        C_ty = (dth * weights[:, None]).T @ dg
        C_yy = (dg * weights[:, None]).T @ dg + Sigma_nu
        K = C_ty @ torch.linalg.solve(C_yy, eye_y)
        m = m_hat + K @ (y_obs - y_hat)
        C = C_hat - K @ C_ty.T
        errors.append(float(torch.sum((y_hat - y_obs) ** 2)))

    return EKIResult(theta=m, ensemble=theta.T,
                     errors=_f64(errors, device), iterations=n_iterations)


def calibrate_abifm(ic, t_end, parcel_kwargs, y_obs, noise_std=0.05,
                    prior_mean=(40.0, -6.0), prior_std=(15.0, 5.0),
                    n_ensemble=25, n_iterations=8, observable="frozen_frac",
                    n_obs_times=5, method="EKI",
                    device: torch.device | str = "cuda"):
    """Calibrate ABIFM ``(m, c)`` against observed frozen fractions from a
    parcel simulation: the reference's ice_nucleation_2024 workflow with
    the parcel ensemble as the forward map.

    ``ic`` is a :class:`~.parcel.ParcelState` of scalars (numbers or
    0-dim tensors); it is taken in float64 on ``device`` and broadcast to
    the ensemble, whose members carry their own ``ABIFM_m`` and ``ABIFM_c``
    as ``(n_ens,)`` tensors of the Illite species."""
    from ..parameters.aerosol_species import Illite
    from . import parcel as PM

    device = torch.device(device)
    base_aerosol = Illite()
    ic = PM.ParcelState(*(_f64(v, device) for v in ic))

    def forward(theta):
        n = theta.shape[0]
        aerosol = dataclasses.replace(base_aerosol, ABIFM_m=theta[:, 0],
                                      ABIFM_c=theta[:, 1])
        params = PM.parcel_params(aerosol=aerosol, **parcel_kwargs)
        # run_parcel sizes its trajectory from the initial condition
        members = PM.ParcelState(*(v.expand(n).contiguous() for v in ic))
        traj = PM.run_parcel(members, 0.0, t_end, params)
        N_tot = traj.N_liq + traj.N_ice
        frozen_frac = traj.N_ice / torch.clamp(N_tot, min=1.0)  # (n_t, n)
        idx = np.linspace(0, frozen_frac.shape[0] - 1, n_obs_times
                          ).astype(int)
        return frozen_frac[torch.as_tensor(idx, device=device)].T

    n_obs = len(y_obs)
    noise_cov = np.eye(n_obs) * noise_std**2
    if method == "UKI":
        return uki_calibrate(forward, prior_mean, prior_std, y_obs,
                             noise_cov, n_iterations=n_iterations,
                             device=device)
    return eki_calibrate(forward, prior_mean, prior_std, y_obs, noise_cov,
                         n_ensemble=n_ensemble, n_iterations=n_iterations,
                         device=device)
