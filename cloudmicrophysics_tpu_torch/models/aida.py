"""AIDA chamber-data calibration workflow.

Port of ``cloudmicrophysics_tpu/models/aida.py`` (reference
``papers/ice_nucleation_2024/unpack_AIDA.jl`` + ``AIDA_calibrations.jl``):
unpack an AIDA ``.edf`` profile, derive frozen-fraction observations over
the freezing window, and run EKI/UKI with the parcel ensemble as the
forward map (:mod:`.calibration`).

The chamber files come from the AIDA artifact
(:func:`cloudmicrophysics_tpu_torch.utils.artifacts.AIDA_ice_nucleation`);
this module only needs the parsed arrays, so synthetic profiles work for
testing and perfect-model studies. Parsing and observations are numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["AIDAProfile", "unpack_aida_edf", "aida_observations",
           "calibrate_abifm_aida"]


class AIDAProfile(NamedTuple):
    """Parsed AIDA chamber time series (SI units)."""

    t: np.ndarray       # [s]
    P: np.ndarray       # [Pa]
    T: np.ndarray       # [K]
    e: np.ndarray       # vapor partial pressure [Pa]
    ICNC: np.ndarray    # ice number concentration [1/m^3]


def unpack_aida_edf(path, skipstart: int = 225) -> AIDAProfile:
    """Parse an AIDA ``.edf`` file (reference unpack_AIDA.jl:25-40:
    whitespace-delimited, 225 header lines; columns
    ``t  P[hPa]  T[K]  e[Pa]  _  ICNC[1/cm^3]``)."""
    raw = np.loadtxt(path, skiprows=skipstart)
    return AIDAProfile(
        t=raw[:, 0], P=raw[:, 1] * 1e2, T=raw[:, 2], e=raw[:, 3],
        ICNC=raw[:, 5] * 1e6)


def moving_average(data: np.ndarray, n: int) -> np.ndarray:
    """Boxcar smoothing with window ``len(data)/n``
    (reference unpack_AIDA.jl:19-23)."""
    w = max(int(round(len(data) / n)), 1)
    kernel = np.ones(w) / w
    pad = np.pad(data, (w // 2, w - 1 - w // 2), mode="edge")
    return np.convolve(pad, kernel, mode="valid")


def aida_observations(profile: AIDAProfile, t_start: float, t_end: float,
                      N_total: float, n_obs: int = 5,
                      smooth_n: int = 50) -> np.ndarray:
    """Frozen-fraction observations over the freezing window
    (reference AIDA_calibrations.jl: ICNC / N_total at sampled times,
    movmean-smoothed)."""
    mask = (profile.t >= t_start) & (profile.t <= t_end)
    icnc = moving_average(np.nan_to_num(profile.ICNC[mask]), smooth_n)
    frozen = np.clip(icnc / N_total, 0.0, 1.0)
    idx = np.linspace(0, len(frozen) - 1, n_obs).astype(int)
    return frozen[idx]


def calibrate_abifm_aida(profile: AIDAProfile, t_start, t_end, N_total,
                         N_liq, r_liq, aerosol_name: str = "Illite",
                         n_obs: int = 5, method: str = "EKI",
                         device="cuda", **cal_kwargs):
    """End-to-end AIDA calibration: chamber IC at ``t_start`` + frozen
    fractions -> EKI/UKI over the parcel forward map on ``device`` (the
    GPU unless ``device="cpu"`` is asked for). Returns the
    :class:`~cloudmicrophysics_tpu_torch.models.calibration.EKIResult`."""
    import torch

    from ..ops import thermo as TDI
    from ..parameters import ThermodynamicsParameters
    from . import parcel as PM
    from .calibration import calibrate_abifm

    tps = ThermodynamicsParameters()
    i0 = int(np.searchsorted(profile.t, t_start))
    T0, p0, e0 = profile.T[i0], profile.P[i0], profile.e[i0]

    def F(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    e_sl = float(TDI.saturation_vapor_pressure_over_liquid(tps, F(T0)))

    md = (p0 - e0) / tps.R_d / T0
    mv = e0 / tps.R_v / T0
    ml = N_liq * 4 / 3 * np.pi * 1000.0 * r_liq**3
    mt = md + mv + ml
    ic = PM.ParcelState(
        S_l=F(e0 / e_sl), p_air=F(p0), T=F(T0), q_vap=F(mv / mt),
        q_liq=F(ml / mt), q_ice=F(0.0), N_aer=F(0.0), N_liq=F(N_liq),
        N_ice=F(0.0), ln_inpc=F(0.0))

    y_obs = aida_observations(profile, t_start, t_end, N_total,
                              n_obs=n_obs)
    # effective updraft from the chamber cooling rate over the window:
    # dT/dt = -g w / cp  (adiabatic pump-down as pseudo-ascent)
    i1 = int(np.searchsorted(profile.t, t_end))
    i1 = max(i1, i0 + 1)
    dT_dt = (profile.T[min(i1, len(profile.T) - 1)] - T0) / max(
        profile.t[min(i1, len(profile.t) - 1)] - profile.t[i0], 1.0)
    w_eff = max(-tps.cp_d / 9.81 * dT_dt, 0.0)
    kwargs = dict(heterogeneous="ABIFM",
                  condensation_growth="Condensation",
                  const_dt=1.0, w=w_eff)
    return calibrate_abifm(ic, t_end - t_start, kwargs, y_obs,
                           n_obs_times=n_obs, method=method, device=device,
                           **cal_kwargs)
