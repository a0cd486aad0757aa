"""Liquid-only parcel vs Rogers (1975) Fig 1
(reference parcel/Example_Liquid_only.jl)."""

import math

import numpy as np
import torch

from ..models import parcel as PM
from ..ops import thermo as TDI
from .common import (TPS, device_of, host, parcel_ic, parse_args,
                     print_summary, summary, to_numpy)

# Rogers (1975) Figure 1 digitized (reference Example_Liquid_only.jl:49-52)
ROGERS_T_S = [0.0645, 0.511, 0.883, 1.4, 2.07, 2.72, 3.24, 3.89, 4.53,
              5.87, 7.16, 9.79, 16.0, 19.8]
ROGERS_S = [0.0268, 0.255, 0.393, 0.546, 0.707, 0.805, 0.863, 0.905,
            0.938, 0.971, 0.978, 0.963, 0.910, 0.885]
DSDS = ("Monodisperse", "Gamma")


def run(device=None, dtype=torch.float64, t_end=20.0):
    """Both size distributions; the Monodisperse run's error against
    Rogers' curve, in percent of supersaturation."""
    device = device_of(device)
    N_l, r0, rho_l = 200e6, 8e-6, 1000.0
    p0, T0 = 800e2, 273.15 + 7.0
    e = float(TDI.saturation_vapor_pressure_over_liquid(TPS, host(T0)))
    md = (p0 - e) / TPS.R_d / T0
    mv = e / TPS.R_v / T0
    ml = N_l * 4 / 3 * math.pi * rho_l * r0**3
    ic = parcel_ic(p0, T0, mv / (md + mv + ml), ml / (md + mv + ml), 0.0,
                   0.0, N_l, 0.0, device=device, dtype=dtype)
    out = {"steps": 0}
    for dsd in DSDS:
        params = PM.parcel_params(liq_size_distribution=dsd,
                                  condensation_growth="Condensation",
                                  const_dt=0.5, w=10.0)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        out[dsd] = summary(traj)
        out["steps"] += traj.S_l.shape[0] - 1
        if dsd == "Monodisperse":
            S_l = to_numpy(traj.S_l)
            t = np.arange(len(S_l)) * 0.5
            S = (S_l - 1) * 100
            err = [abs(np.interp(tt, t, S) - ss)
                   for tt, ss in zip(ROGERS_T_S, ROGERS_S)]
            out["rogers_max_err"] = float(max(err))
            out["rogers_mean_err"] = float(np.mean(err))
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for dsd in DSDS:
        print_summary(f"liquid only / {dsd}", out[dsd])
        if dsd == "Monodisperse":
            print(f"  max |S - Rogers1975| = {out['rogers_max_err']:.3f} % "
                  f"(mean {out['rogers_mean_err']:.3f} %)")
    return out


if __name__ == "__main__":
    main()
