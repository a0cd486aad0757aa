"""Homogeneous freezing at cirrus temperatures vs Jensen et al. (2022)
Fig 1 (reference parcel/Example_Jensen_et_al_2022.jl)."""

import math

import numpy as np
import torch

from ..models import parcel as PM
from ..ops import thermo as TDI
from .common import (TPS, device_of, host, parcel_ic, parse_args, to_numpy,
                     vapor_mixing_to_q)

# Jensen (2022) Fig 1 digitized (reference Example_Jensen_et_al_2022.jl:53-58)
JENSEN_T_SAT = [0, 62.71, 70.52, 76.87, 82.4, 84.84, 88.1, 92, 96.07,
                100.63, 105.35, 112.51, 119.83]
JENSEN_SAT = [1.55, 1.694, 1.7107, 1.7208, 1.725, 1.726, 1.7259, 1.722,
              1.715, 1.702, 1.686, 1.653, 1.6126]
JENSEN_ICNC_END = 17.086  # cm^-3 at t=120 s


def run(device=None, dtype=torch.float64, t_end=120.0):
    """ABHOM at dt 0.01 s: the peak ice saturation ratio (S_l times the
    initial ratio of the saturation pressures, as the script takes it),
    the ICNC at the end in cm^-3 and S_i at Jensen's sampled times."""
    device = device_of(device)
    T0, c_v0 = 190.0, 5e-6
    N_l, r0, sigma = 300e6, 25e-9, 2.0
    q_v = float(vapor_mixing_to_q(c_v0))
    q_l = N_l * 4 / 3 * math.pi * math.exp((6 * math.log(r0)
                                            + 9 * sigma**2) / 2)
    e_s = float(TDI.saturation_vapor_pressure_over_liquid(TPS, host(T0)))
    xi = e_s / float(TDI.saturation_vapor_pressure_over_ice(TPS, host(T0)))
    S_l = 1.55 / xi
    p0 = S_l * e_s / c_v0
    ic = parcel_ic(p0, T0, q_v, q_l, 0.0, 0.0, N_l, 0.0, device=device,
                   dtype=dtype)
    params = PM.parcel_params(homogeneous="ABHOM",
                              deposition_growth="Deposition",
                              const_dt=0.01, w=1.0)
    traj = PM.run_parcel(ic, 0.0, t_end, params)
    S_i = to_numpy(traj.S_l) * xi  # approximately (T drifts ~1 K)
    icnc = to_numpy(traj.N_ice) / 1e6
    t = np.arange(len(S_i)) * 0.01
    return {"steps": len(S_i) - 1, "peak_S_ice": float(S_i.max()),
            "icnc_end": float(icnc[-1]),
            "S_i_at": [float(np.interp(tt, t, S_i))
                       for tt in JENSEN_T_SAT[::4]]}


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    print(f"peak S_ice = {out['peak_S_ice']:.4f} (Jensen: 1.726)")
    print(f"ICNC(end)  = {out['icnc_end']:.2f} cm^-3 (Jensen: "
          f"{JENSEN_ICNC_END})")
    for tt, ss, si in zip(JENSEN_T_SAT[::4], JENSEN_SAT[::4], out["S_i_at"]):
        print(f"  t={tt:6.1f}s  S_i={si:.4f} (Jensen {ss:.4f})")
    return out


if __name__ == "__main__":
    main()
