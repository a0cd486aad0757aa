"""ABIFM immersion freezing of illite-containing droplets
(reference parcel/Example_Immersion_Freezing.jl)."""

import math

import numpy as np
import torch

from ..models import parcel as PM
from ..parameters.aerosol_species import Illite
from .common import (device_of, frozen_fraction, parcel_ic, parse_args,
                     print_summary, summary, to_numpy)

DSDS = ("Monodisperse", "Gamma")


def run(device=None, dtype=torch.float64, t_end=600.0):
    """Both size distributions: the frozen fraction at step 300 and at the
    end, and whether it never falls by more than 1e-12."""
    device = device_of(device)
    N_l, r0 = 2e8, 1e-6
    q_l = N_l * 4 / 3 * math.pi * r0**3 * 1000.0 / 1.2
    ic = parcel_ic(800e2, 251.0, 8.1e-4, q_l, 0.0, 0.0, N_l, 0.0,
                   device=device, dtype=dtype)
    out = {"steps": 0}
    for dsd in DSDS:
        params = PM.parcel_params(
            aerosol=Illite(), heterogeneous="ABIFM",
            condensation_growth="Condensation",
            deposition_growth="Deposition",
            liq_size_distribution=dsd, ice_size_distribution=dsd,
            const_dt=1.0, w=0.4)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        ff = to_numpy(frozen_fraction(traj))
        out["steps"] += traj.S_l.shape[0] - 1
        out[dsd] = dict(summary(traj), ff_300=float(ff[300]),
                        ff_end=float(ff[-1]),
                        monotone=bool((np.diff(ff) >= -1e-12).all()))
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for dsd in DSDS:
        s = out[dsd]
        print_summary(f"ABIFM immersion / {dsd}", s)
        print(f"  frozen fraction: t=300s {s['ff_300']:.3e}, "
              f"t=600s {s['ff_end']:.3e} (monotone: {s['monotone']})")
    return out


if __name__ == "__main__":
    main()
