"""The JAX record of the examples, kept in the port package
(``cloudmicrophysics_tpu_torch/data/examples_f64.json``), and the
examples' entry points.

* The record holds, from the JAX package on the CPU at x64, the numbers
  each script of ``examples/`` prints, unrounded, under the keys of the
  port's ``run()`` (the functions below restate each script's computation
  with the JAX package and return them): at full length, and for NonEq and
  Tully at the cut lengths ``chip_smoke.py`` runs (each run's first 2000
  steps). It holds each script's own output as printed, the mean, spread
  and range over 16 JAX keys of the four runs that draw random numbers,
  and the squall's one-step references (below).
* The test regenerates the cheap entries (liquid-only, activation, P3
  nucleation, the deterministic box) from JAX and fails if the file
  disagrees; ``python tests/test_torch_examples.py`` rewrites it (about
  five minutes: it runs the twelve scripts).
* ``run()`` with no device asks for CUDA: on a machine without a card it
  raises, and nothing runs on the CPU instead.

The squall is not held over its rollout: its 2 s explicit step is
unstable in the reference. At float64 the JAX rollout is non-finite
within a few steps; at float32 a one-ulp change of the initial state, or
another column count, moves the final ice water path from 32 to over 9000
kg m^-2 (the record's ``squall.*.ensemble_iwp``). The record instead holds
states of the JAX float32 rollout, JAX's float64 step from each, and JAX's
own float32 step's error against it (``tests/test_torch_examples_squall.py``).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu as cm
import cloudmicrophysics_tpu_torch
from cloudmicrophysics_tpu.models import box as JBOX
from cloudmicrophysics_tpu.models import parcel as JPM
from cloudmicrophysics_tpu.models.column import ColumnStateP3, step_column_p3
from cloudmicrophysics_tpu.ops import thermo as JTD
from cloudmicrophysics_tpu.ops.ice_nucleation import INP_concentration_mean
from cloudmicrophysics_tpu.parameters import aerosol_species as JSP
from cloudmicrophysics_tpu.parameters.ice_nucleation import Frostenberg2023
from cloudmicrophysics_tpu_torch.examples import NAMES
from cloudmicrophysics_tpu_torch.examples.parcel_jensen_2022 import (
    JENSEN_T_SAT,
)
from cloudmicrophysics_tpu_torch.examples.parcel_liquid_only import (
    ROGERS_S,
    ROGERS_T_S,
)

ROOT = Path(__file__).resolve().parent.parent
RECORD = (Path(cloudmicrophysics_tpu_torch.__file__).resolve().parent
          / "data" / "examples_f64.json")
RTOL, ATOL_REL = 1e-12, 1e-12
F = jnp.float64
TPS = cm.parameters.ThermodynamicsParameters()
# chip_smoke.py's cuts: each run's first 2000 steps
CUTS = {"parcel_noneq": {"t_end": 2.0},
        "parcel_tully_2023": {"t_max": 200.0}}
N_KEYS = 16
# the squall's configurations: the script's default and the full-width
# cell's levels, spacing and order over the same 16 km column
SQUALL = {"small": dict(nlev=64, dz=250.0, order=8),
          "full": dict(nlev=128, dz=125.0, order=16)}
SQUALL_DT, SQUALL_STEPS = 2.0, 120
SQUALL_INPUTS = (0, 1, 2, 5, 20, 60, 119)   # states held: after these steps


# ---------------------------------------------------------------------------
# the scripts' computations with the JAX package (examples/*.py)
# ---------------------------------------------------------------------------

def parcel_ic(p_air, T, q_vap, q_liq, q_ice, N_aer, N_liq, N_ice,
              ln_inpc=0.0):
    q_tot = q_vap + q_liq + q_ice
    R_a = (TPS.R_d * (1 - q_tot) + TPS.R_v * q_vap)
    e_sl = JTD.saturation_vapor_pressure_over_liquid(TPS, F(T))
    e = q_vap * p_air * TPS.R_v / R_a
    return JPM.ParcelState(
        S_l=F(e / e_sl), p_air=F(p_air), T=F(T), q_vap=F(q_vap),
        q_liq=F(q_liq), q_ice=F(q_ice), N_aer=F(N_aer), N_liq=F(N_liq),
        N_ice=F(N_ice), ln_inpc=F(ln_inpc))


def vapor_mixing_to_q(c_v):
    eps_m = TPS.R_d / TPS.R_v
    return eps_m / (eps_m - 1 + 1 / c_v)


def frozen_fraction(traj):
    return np.asarray(traj.N_ice) / np.maximum(
        np.asarray(traj.N_liq) + np.asarray(traj.N_ice), 1.0)


def summary(traj):
    end = {k: float(getattr(traj, k)[-1])
           for k in ("S_l", "T", "q_liq", "q_ice", "N_liq", "N_ice")}
    return dict(end, peak_S=float(jnp.max(traj.S_l)) - 1,
                peak_step=int(jnp.argmax(traj.S_l)))


def _steps(traj):
    return int(traj.S_l.shape[0]) - 1


def liquid_only(t_end=20.0):
    N_l, r0, rho_l = 200e6, 8e-6, 1000.0
    p0, T0 = 800e2, 273.15 + 7.0
    e = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
    md = (p0 - e) / TPS.R_d / T0
    mv = e / TPS.R_v / T0
    ml = N_l * 4 / 3 * np.pi * rho_l * r0**3
    ic = parcel_ic(p0, T0, mv / (md + mv + ml), ml / (md + mv + ml), 0.0,
                   0.0, N_l, 0.0)
    out = {"steps": 0}
    for dsd in ("Monodisperse", "Gamma"):
        params = JPM.parcel_params(liq_size_distribution=dsd,
                                   condensation_growth="Condensation",
                                   const_dt=0.5, w=10.0)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out[dsd] = summary(traj)
        out["steps"] += _steps(traj)
        if dsd == "Monodisperse":
            t = np.arange(len(np.asarray(traj.S_l))) * 0.5
            S = (np.asarray(traj.S_l) - 1) * 100
            err = [abs(np.interp(tt, t, S) - ss)
                   for tt, ss in zip(ROGERS_T_S, ROGERS_S)]
            out["rogers_max_err"] = float(max(err))
            out["rogers_mean_err"] = float(np.mean(err))
    return out


def aerosol_activation(t_end=35.0):
    N_a, T0, c_v0 = 5e8, 230.0, 5e-5
    q_v = float(vapor_mixing_to_q(c_v0))
    e_s = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
    p0 = 0.99 * e_s / c_v0
    ic = parcel_ic(p0, T0, q_v, 0.0, 0.0, N_a, 0.0, 0.0)
    params = JPM.parcel_params(
        aerosol_act="AeroAct", aerosol=JSP.Sulfate(), aero_sigma_g=2.3,
        r_nuc=3e-7, N_aer_act=N_a,
        condensation_growth="Condensation", const_dt=1.0, w=1.2)
    traj = JPM.run_parcel(ic, 0.0, t_end, params)
    N_act = np.asarray(traj.N_liq)
    return {"steps": _steps(traj), "Sulfate": summary(traj),
            "activated_fraction": float(N_act[-1] / N_a),
            "onset_step": (int(np.argmax(N_act > 1e3))
                           if (N_act > 1e3).any() else -1)}


def immersion_freezing(t_end=600.0):
    N_l, r0 = 2e8, 1e-6
    q_l = N_l * 4 / 3 * np.pi * r0**3 * 1000.0 / 1.2
    ic = parcel_ic(800e2, 251.0, 8.1e-4, q_l, 0.0, 0.0, N_l, 0.0)
    out = {"steps": 0}
    for dsd in ("Monodisperse", "Gamma"):
        params = JPM.parcel_params(
            aerosol=JSP.Illite(), heterogeneous="ABIFM",
            condensation_growth="Condensation",
            deposition_growth="Deposition",
            liq_size_distribution=dsd, ice_size_distribution=dsd,
            const_dt=1.0, w=0.4)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        ff = frozen_fraction(traj)
        out["steps"] += _steps(traj)
        out[dsd] = dict(summary(traj), ff_300=float(ff[300]),
                        ff_end=float(ff[-1]),
                        monotone=bool((np.diff(ff) >= -1e-12).all()))
    return out


def deposition_nucleation(t_end=100.0):
    ic = parcel_ic(20000.0, 230.0, 3.3e-4, 0.0, 0.0, 2000e3, 0.0, 0.0)
    runs = ([("MohlerRate", a) for a in (JSP.DesertDust(),
                                         JSP.ArizonaTestDust())]
            + [("ABDINM", a) for a in (JSP.Feldspar(), JSP.Ferrihydrite(),
                                       JSP.Kaolinite())])
    out = {"steps": 0}
    for mode, aero in runs:
        params = JPM.parcel_params(
            aerosol=aero, deposition=mode, deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=3.5e-2)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += _steps(traj)
        out[f"{mode} / {type(aero).__name__}"] = summary(traj)
    return out


def p3_ice_nuc(t_end=50.0):
    N_a, N_l, r_l = 2000.0, 2000.0, 1.25e-6
    p0, q_v = 20000.0, 5e-4
    q_l = N_l * 4 / 3 * np.pi * r_l**3 * 1000.0 / 1.2
    runs = (("P3_dep", 235.0, dict(deposition="P3_dep")),
            ("P3_het", 235.0, dict(heterogeneous="P3_het",
                                   aerosol=JSP.Illite())),
            ("P3_hom", 233.2, dict(homogeneous="P3_hom")))
    out = {"steps": 0}
    for name, T0, sel in runs:
        ic = parcel_ic(p0, T0, q_v, q_l, 0.0, N_a, N_l, 0.0)
        params = JPM.parcel_params(
            deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=0.5, **sel)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += _steps(traj)
        s = summary(traj)
        out[name] = dict(s, icnc_end=float(traj.N_ice[-1]) / 1e6)
    return out


def p3_vs_activitybased(t_end=50.0):
    N_a, N_l, r_l = 2000.0, 2000.0, 1.25e-6
    p0, q_v = 20000.0, 8.3e-4
    q_l = N_l * 4 / 3 * np.pi * r_l**3 * 1000.0 / 1.2
    T_dep, T_het, T_hom = 238.0, 239.0, 236.5
    out = {"steps": 0}

    def run(label, T0, **sel):
        ic = parcel_ic(p0, T0, q_v, q_l, 0.0, N_a, N_l, 0.0)
        params = JPM.parcel_params(
            deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=0.5, **sel)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += _steps(traj)
        out[label] = float(traj.N_ice[-1])

    run("P3_dep", T_dep, deposition="P3_dep")
    for aero in (JSP.Feldspar(), JSP.Ferrihydrite(), JSP.Kaolinite()):
        run(f"ABDINM {type(aero).__name__}", T_dep, deposition="ABDINM",
            aerosol=aero, A_aer=1e-10)
    run("P3_het", T_het, heterogeneous="P3_het")
    for aero in (JSP.DesertDust(), JSP.Illite(), JSP.Kaolinite()):
        run(f"ABIFM {type(aero).__name__}", T_het, heterogeneous="ABIFM",
            aerosol=aero, condensation_growth="Condensation")
    run("P3_hom", T_hom, homogeneous="P3_hom")
    run("ABHOM", T_hom, homogeneous="ABHOM")
    return out


def jensen_2022(t_end=120.0):
    T0, c_v0 = 190.0, 5e-6
    N_l, r0, sigma = 300e6, 25e-9, 2.0
    q_v = float(vapor_mixing_to_q(c_v0))
    q_l = N_l * 4 / 3 * np.pi * np.exp((6 * np.log(r0) + 9 * sigma**2) / 2)
    e_s = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
    xi = e_s / float(JTD.saturation_vapor_pressure_over_ice(TPS, F(T0)))
    p0 = 1.55 / xi * e_s / c_v0
    ic = parcel_ic(p0, T0, q_v, q_l, 0.0, 0.0, N_l, 0.0)
    params = JPM.parcel_params(homogeneous="ABHOM",
                               deposition_growth="Deposition",
                               const_dt=0.01, w=1.0)
    traj = JPM.run_parcel(ic, 0.0, t_end, params)
    S_i = np.asarray(traj.S_l) * xi
    icnc = np.asarray(traj.N_ice) / 1e6
    t = np.arange(len(S_i)) * 0.01
    return {"steps": len(S_i) - 1, "peak_S_ice": float(S_i.max()),
            "icnc_end": float(icnc[-1]),
            "S_i_at": [float(np.interp(tt, t, S_i))
                       for tt in JENSEN_T_SAT[::4]]}


FROSTENBERG = (("Frostenberg_mean", {}),
               ("Frostenberg_random", {"sampling_interval": 60.0}),
               ("Frostenberg_stochastic", {"gamma": 1.0}),
               ("Frostenberg_stochastic", {"gamma": 0.01}))


def frostenberg_setup():
    ip = Frostenberg2023()
    N_l, r0, T0 = 500e3, 1e-6, 251.0
    q_l = N_l * 4 / 3 * np.pi * r0**3 * 1000.0 / 1.2
    ln_inpc0 = float(INP_concentration_mean(ip, T0))
    ic = parcel_ic(800e2, T0, 8.1e-4, q_l, 0.0, 0.0, N_l, 0.0,
                   ln_inpc=ln_inpc0)
    common = dict(condensation_growth="Condensation",
                  deposition_growth="Deposition", const_dt=1.0, w=0.7)
    return ic, [(f"{mode} {extra or ''}",
                 JPM.parcel_params(heterogeneous=mode, **common, **extra))
                for mode, extra in FROSTENBERG]


def _frostenberg_numbers(traj):
    return dict(summary(traj), ff_end=float(frozen_fraction(traj)[-1]))


def frostenberg_immersion(t_end=1200.0):
    ic, runs = frostenberg_setup()
    out = {"steps": 0}
    for label, params in runs:
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += _steps(traj)
        out[label] = _frostenberg_numbers(traj)
    return out


def noneq(t_end=20.0):
    N_l, N_i = 200e6, 1e6
    r_l, r_i = 1e-6, 8e-6
    p0, T0 = 800e2, 243.0
    e = float(JTD.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
    md = (p0 - e) / TPS.R_d / T0
    mv = e / TPS.R_v / T0
    ml = N_l * 4 / 3 * np.pi * 1000.0 * r_l**3
    mi = N_i * 4 / 3 * np.pi * 916.7 * r_i**3
    mt = md + mv + ml + mi
    ic = parcel_ic(p0, T0, mv / mt, ml / mt, mi / mt, 0.0, N_l, N_i)
    out = {"steps": 0}
    for tau in (0.01, 0.1, 1.0):
        params = JPM.parcel_params(
            condensation_growth="NonEq_Condensation",
            deposition_growth="NonEq_Deposition_simple",
            noneq_tau=tau, const_dt=0.001, w=1.0)
        traj = JPM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += _steps(traj)
        out[f"tau={tau}"] = summary(traj)
    return out


def tully_2023(t_max=30 * 60.0):
    N_aer = 2000e3
    p0, T0, qv0 = 20000.0, 230.0, 3.3e-4
    T2, T3 = 229.25, 228.55
    out = {"steps": 0}
    for mode in ("MohlerAF", "MohlerRate"):
        params = JPM.parcel_params(
            aerosol=JSP.DesertDust(), deposition=mode,
            deposition_growth="Deposition",
            liq_size_distribution="Monodisperse",
            r_nuc=0.5e-4 * 1e-6, const_dt=0.1, w=3.5e-2)
        ic = parcel_ic(p0, T0, qv0, 0.0, 0.0, N_aer, 0.0, 0.0)
        traj1 = JPM.run_parcel(ic, 0.0, t_max, params)
        ic2 = parcel_ic(float(traj1.p_air[-1]), T2, qv0, 0.0,
                        float(traj1.q_ice[-1]), float(traj1.N_aer[-1]),
                        float(traj1.N_liq[-1]), float(traj1.N_ice[-1]))
        traj2 = JPM.run_parcel(ic2, t_max, 2 * t_max, params)
        ic3 = parcel_ic(float(traj2.p_air[-1]), T3, qv0, 0.0,
                        float(traj2.q_ice[-1]), float(traj2.N_aer[-1]),
                        float(traj2.N_liq[-1]), float(traj2.N_ice[-1]))
        traj3 = JPM.run_parcel(ic3, 2 * t_max, 3 * t_max, params)
        out[mode] = []
        for tr in (traj1, traj2, traj3):
            out["steps"] += _steps(tr)
            out[mode].append({"N_ice_start": float(tr.N_ice[0]),
                              "N_ice_end": float(tr.N_ice[-1]),
                              "peak_S_l": float(np.max(np.asarray(tr.S_l)))})
    return out


BOX = dict(A_aero=1e-5 * 1e-4, sigma_g=10.0, N0=1000, T0=256.0,
           cooling=0.5 / 60, dt=10.0)


def box_surface_areas():
    rng = np.random.default_rng(42)
    return np.sort(rng.lognormal(np.log(BOX["A_aero"]),
                                 np.log(BOX["sigma_g"]),
                                 BOX["N0"]))[::-1].copy()


def box_stochastic(key, t_end=3310.0):
    b = BOX
    T_t, _, N_ice_t, _ = JBOX.run_box_stochastic(
        F(b["T0"]), box_surface_areas(), 0.0, t_end, TPS, JSP.Illite(),
        b["cooling"], b["dt"], key)
    N = np.asarray(N_ice_t)
    return int(T_t.shape[0]), {
        "ff_sto": float(N[-1] / b["N0"]),
        "half_sto": int(np.argmax(N >= b["N0"] / 2))}


def box_alpert_knopf(t_end=3310.0):
    b = BOX
    ic = JBOX.BoxState(T=F(b["T0"]), A_sum=F(b["N0"] * b["A_aero"]),
                       N_liq=F(b["N0"]), N_ice=F(0.0))
    traj = JBOX.run_box(ic, 0.0, t_end, TPS, JSP.Illite(), b["cooling"],
                        b["A_aero"], b["dt"])
    n_sto, sto = box_stochastic(jax.random.PRNGKey(7), t_end)
    N_det = np.asarray(traj.N_ice)
    return {"steps": int(traj.T.shape[0]) - 1 + n_sto,
            "T_start": float(traj.T[0]), "T_end": float(traj.T[-1]),
            "ff_det": float(N_det[-1] / b["N0"]),
            "ff_sto": sto["ff_sto"],
            "half_det": int(np.argmax(N_det >= b["N0"] / 2)),
            "half_sto": sto["half_sto"]}


RUNNERS = {
    "parcel_liquid_only": liquid_only,
    "parcel_aerosol_activation": aerosol_activation,
    "parcel_immersion_freezing": immersion_freezing,
    "parcel_deposition_nucleation": deposition_nucleation,
    "parcel_p3_ice_nuc": p3_ice_nuc,
    "parcel_p3_vs_activitybased": p3_vs_activitybased,
    "parcel_jensen_2022": jensen_2022,
    "parcel_frostenberg_immersion": frostenberg_immersion,
    "parcel_noneq": noneq,
    "parcel_tully_2023": tully_2023,
    "box_alpert_knopf_2016": box_alpert_knopf,
}
CHEAP = ("parcel_liquid_only", "parcel_aerosol_activation",
         "parcel_p3_ice_nuc")


def _stats(samples):
    """{number: [mean, std, min, max]} over a list of flat dicts."""
    return {k: [float(np.mean(v)), float(np.std(v)), float(np.min(v)),
                float(np.max(v))]
            for k in samples[0]
            for v in [[s[k] for s in samples]]}


def random_bands():
    """Mean, spread and range over JAX keys 0-15 of every number of the
    runs that draw: the three random Frostenberg variants and the
    stochastic box."""
    ic, runs = frostenberg_setup()
    keys = [jax.random.PRNGKey(i) for i in range(N_KEYS)]
    bands = {"parcel_frostenberg_immersion": {}}
    for label, params in runs[1:]:
        samples = []
        for key in keys:
            traj = JPM.run_parcel(ic, 0.0, 1200.0, params, rng_key=key)
            samples.append(_frostenberg_numbers(traj))
        bands["parcel_frostenberg_immersion"][label] = _stats(samples)
    bands["box_alpert_knopf_2016"] = _stats(
        [box_stochastic(k)[1] for k in keys])
    return bands


# ---------------------------------------------------------------------------
# the squall (examples/column_squall_p3.py)
# ---------------------------------------------------------------------------

def squall_state(ncol, nlev, dz, dtype):
    z = np.linspace(0.0, dz * (nlev - 1), nlev)
    cloud = np.exp(-((z - 2500.0) / 900.0) ** 2)
    anvil = np.exp(-((z - 9000.0) / 1500.0) ** 2)

    def tile(p):
        return jnp.asarray(np.broadcast_to(np.asarray(p, np.float32),
                                           (ncol, nlev)), dtype)

    return ColumnStateP3(
        rho=tile(1.2 * np.exp(-z / 8500.0)), T=tile(292.0 - 7.0e-3 * z),
        q_tot=tile(9e-3 * np.exp(-z / 3000.0)),
        q_lcl=tile(1.2e-3 * cloud), n_lcl=tile(1.0e8 * cloud),
        q_rai=tile(2e-4 * cloud), n_rai=tile(8e5 * cloud),
        q_ice=tile(6e-4 * anvil), n_ice=tile(1.2e5 * anvil),
        q_rim=tile(1.5e-4 * anvil), b_rim=tile(3e-7 * anvil))


def _squall_step(order, dz):
    mp = cm.parameters.microphysics_2m_params(with_ice=True,
                                              quadrature_order=order)
    return jax.jit(lambda s, g: step_column_p3(s, mp, TPS, SQUALL_DT, dz,
                                               g))


def _iwp(state, dz):
    return (np.sum(np.asarray(state.rho, np.float64)
                   * np.asarray(state.q_ice, np.float64), axis=1) * dz)


def squall_error(got, want, set_aside=True):
    """Per field: the largest absolute difference over the field's largest
    magnitude. With ``set_aside`` (for two steps with the same trip count
    of the Brent solve), only in the cells where log lambda agrees to 1e-6
    and so does each cell's vertical neighbours' (elsewhere the fixed-trip
    Brent stopped at another iterate; sedimentation carries that to the
    neighbours). Returns (errors, cells set aside)."""
    ll_g, ll_w = np.asarray(got[1], np.float64), np.asarray(want[1])
    fin = np.isfinite(ll_w) & np.isfinite(ll_g)
    off = np.isinf(ll_g) != np.isinf(ll_w)
    off[fin] = np.abs(ll_g[fin] - ll_w[fin]) > 1e-6 * np.abs(ll_w[fin])
    aside = off.copy()
    aside[..., 1:] |= off[..., :-1]
    aside[..., :-1] |= off[..., 1:]
    if not set_aside:
        aside[:] = False
    errs = {}
    for name, g, w in zip(ColumnStateP3._fields, got[0], want[0]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        errs[name] = float(np.max(np.abs(g - w)[~aside], initial=0.0)
                           / scale)
    return errs, int(aside.sum())


def squall_record(nlev, dz, order):
    """One column of the JAX float32 rollout: the states after
    SQUALL_INPUTS steps with their log lambda (the next step's guess),
    JAX's float64 step from each, JAX's float32 step's error against it
    over every cell (its Brent solve stops after fewer trips), the step
    at which the float64 rollout is first non-finite, and the
    final ice water path of 16 columns whose initial cells differ by up
    to one float32 ulp (column 0 unperturbed)."""
    step = _squall_step(order, dz)
    inputs = []
    # the script's program: float32, x64 off
    with jax.enable_x64(False):
        st, guess = squall_state(1, nlev, dz, jnp.float32), None
        for i in range(SQUALL_STEPS):
            if i in SQUALL_INPUTS:
                inputs.append((ColumnStateP3(*(np.asarray(x) for x in st)),
                               None if guess is None else np.asarray(guess)))
            st, guess = step(st, guess)
    out = {"inputs": [], "f64_step": [], "jax_float32_error": [],
           "input_steps": list(SQUALL_INPUTS)}
    for s, g in inputs:
        s64 = ColumnStateP3(*(jnp.asarray(x, jnp.float64) for x in s))
        g64 = None if g is None else jnp.asarray(g, jnp.float64)
        want = step(s64, g64)
        with jax.enable_x64(False):
            got = step(ColumnStateP3(*(jnp.asarray(x) for x in s)),
                       None if g is None else jnp.asarray(g))
            got = (ColumnStateP3(*(np.asarray(x) for x in got[0])),
                   np.asarray(got[1]))
        errs, _ = squall_error(got, want, set_aside=False)
        out["inputs"].append({
            "state": {k: np.asarray(v[0], np.float64).tolist()
                      for k, v in s._asdict().items()},
            "guess": None if g is None else np.asarray(g[0], np.float64)
            .tolist()})
        out["f64_step"].append({
            "state": {k: np.asarray(v[0]).tolist()
                      for k, v in want[0]._asdict().items()},
            "loglambda": np.asarray(want[1][0]).tolist()})
        out["jax_float32_error"].append(errs)
    # the float64 rollout
    st, guess = squall_state(1, nlev, dz, jnp.float64), None
    out["f64_first_nonfinite_step"] = None
    for i in range(SQUALL_STEPS):
        st, guess = step(st, guess)
        if not all(bool(np.isfinite(np.asarray(x)).all()) for x in st):
            out["f64_first_nonfinite_step"] = i
            break
    # the float32 rollout's sensitivity to the last bit
    rng = np.random.default_rng(0)

    def nudge(a):
        a = np.array(a)
        k = rng.integers(-1, 2, size=a.shape).astype(np.int32)
        k[0] = 0
        return jnp.asarray((a.view(np.int32) + np.where(a > 0, k, 0))
                           .view(np.float32))

    with jax.enable_x64(False):
        st = squall_state(16, nlev, dz, jnp.float32)
        st, guess = ColumnStateP3(*(nudge(x) for x in st)), None
        for _ in range(SQUALL_STEPS):
            st, guess = step(st, guess)
        out["ensemble_iwp"] = _iwp(st, dz).tolist()
    return out


def script_stdout(name, *args):
    """What the JAX script prints."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, f"{name}.py", *args],
                          cwd=ROOT / "examples", env=env, text=True,
                          capture_output=True, timeout=1200, check=True)
    return proc.stdout


def _record():
    rec = {"about": "JAX float64 numbers of examples/*.py on the CPU; "
                    "written by tests/test_torch_examples.py",
           "full": {name: fn() for name, fn in RUNNERS.items()},
           "cut_kwargs": CUTS,
           "cut": {name: RUNNERS[name](**kw) for name, kw in CUTS.items()},
           "bands": random_bands(),
           "stdout": {name: script_stdout(name) for name in RUNNERS},
           "squall": {k: dict(cfg, dt=SQUALL_DT, steps=SQUALL_STEPS,
                              **squall_record(**cfg))
                      for k, cfg in SQUALL.items()}}
    rec["stdout"]["column_squall_p3"] = script_stdout("column_squall_p3")
    return rec


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    return json.loads(RECORD.read_text())


# the pairs of summary numbers between which a content or number moves:
# each one's absolute floor is ATOL_REL of the larger of the two
PHASE_PAIRS = (("q_liq", "q_ice"), ("N_liq", "N_ice"))


def close(got, want, rtol, what, worst=None):
    """Numbers of two nested records: rtol, with the absolute floor of
    ATOL_REL times the condensate present for a summary's liquid and ice
    contents and numbers (the parcel tests' floor of 1e-12 of the field's
    largest magnitude: freezing moves the contents between the phases, and
    the liquid ends at -5.5e-34 or 0) and of S_l for the peak
    supersaturation S_l - 1 (0 or 2.2e-16 where S_l peaks at its start);
    integers and flags exactly.
    ``worst``, a list, collects ``(relative error, path)``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        floors = {k: ATOL_REL * max(abs(want[a]), abs(want[b]))
                  for a, b in PHASE_PAIRS if a in want for k in (a, b)}
        if "peak_S" in want:    # S_l - 1: the floor of S_l
            floors["peak_S"] = ATOL_REL * (1 + abs(want["peak_S"]))
        for k in want:
            if k in floors:
                np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                           atol=floors[k],
                                           err_msg=f"{what}.{k}")
                if worst is not None and abs(want[k]) > floors[k]:
                    worst.append((abs(got[k] - want[k]) / abs(want[k]),
                                  f"{what}.{k}"))
            else:
                close(got[k], want[k], rtol, f"{what}.{k}", worst)
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, rtol, f"{what}[{i}]", worst)
    elif isinstance(want, (bool, int)):
        assert got == want, (what, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0,
                                   err_msg=what)
        if worst is not None and want != 0:
            worst.append((abs(got - want) / abs(want), what))


_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?%?")


def _unit(token):
    """One unit in the last printed digit of a number's token."""
    mant, _, exp = token.rstrip("%").partition("e")
    places = len(mant.partition(".")[2])
    unit = 10.0 ** (int(exp or 0) - places)
    return unit / 100 if token.endswith("%") else unit


def _value(token):
    v = float(token.rstrip("%"))
    return v / 100 if token.endswith("%") else v


def assert_lines(got, want, numbers=True):
    """The port's lines are the script's: the same text around the
    numbers and, with ``numbers``, each number within one unit of its last
    printed digit of the script's (or both below 1e-30: XLA flushes what
    PyTorch keeps as a subnormal)."""
    got, want = got.strip().splitlines(), want.strip().splitlines()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        if not numbers:
            continue
        for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            x, y = _value(a), _value(b)
            assert (a == b or abs(x - y) <= 1.0001 * _unit(b)
                    or max(abs(x), abs(y)) < 1e-30), (g, w)


@pytest.mark.parametrize("name", CHEAP)
def test_record_is_fresh(stored, name):
    close(RUNNERS[name](), stored["full"][name], RTOL, name)


def test_record_box_is_fresh(stored):
    got = box_alpert_knopf()
    close(got, stored["full"]["box_alpert_knopf_2016"], RTOL, "box")


def test_record_covers_every_example(stored):
    assert set(stored["full"]) | {"column_squall_p3"} == set(NAMES)
    assert set(stored["stdout"]) == set(NAMES)
    for name, kw in CUTS.items():
        assert stored["cut_kwargs"][name] == kw
        assert stored["cut"][name]["steps"] in (6000, 12000)


@pytest.mark.parametrize("name", NAMES)
def test_run_asks_for_cuda_by_default(name):
    """No device: CUDA, which raises without a card rather than running
    on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: run() would run on it")
    mod = importlib.import_module(f"cloudmicrophysics_tpu_torch.examples."
                                  f"{name}")
    kw = {"t_end": 1.0} if "t_end" in mod.run.__code__.co_varnames else {}
    with pytest.raises((RuntimeError, AssertionError)):
        mod.run(**kw)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(_record(), indent=1) + "\n")
    print(f"wrote {RECORD}")
