"""Aerosol activation in a rising parcel
(reference parcel/Example_AerosolActivation.jl)."""

import numpy as np
import torch

from ..models import parcel as PM
from ..ops import thermo as TDI
from ..parameters.aerosol_species import Sulfate
from .common import (TPS, device_of, host, parcel_ic, parse_args,
                     print_summary, summary, to_numpy, vapor_mixing_to_q)


def run(device=None, dtype=torch.float64, t_end=35.0):
    """ARG activation on sulfate: the activated fraction at the end and
    the first step with more than 1e3 droplets per m^3 (-1 if none)."""
    device = device_of(device)
    N_a, T0, c_v0 = 5e8, 230.0, 5e-5
    q_v = float(vapor_mixing_to_q(c_v0))
    e_s = float(TDI.saturation_vapor_pressure_over_liquid(TPS, host(T0)))
    S_l = 0.99
    p0 = S_l * e_s / c_v0
    ic = parcel_ic(p0, T0, q_v, 0.0, 0.0, N_a, 0.0, 0.0, device=device,
                   dtype=dtype)
    params = PM.parcel_params(
        aerosol_act="AeroAct", aerosol=Sulfate(), aero_sigma_g=2.3,
        r_nuc=3e-7, N_aer_act=N_a,
        condensation_growth="Condensation", const_dt=1.0, w=1.2)
    traj = PM.run_parcel(ic, 0.0, t_end, params)
    N_act = to_numpy(traj.N_liq)
    return {"steps": traj.S_l.shape[0] - 1, "Sulfate": summary(traj),
            "activated_fraction": float(N_act[-1] / N_a),
            "onset_step": (int(np.argmax(N_act > 1e3))
                           if (N_act > 1e3).any() else -1)}


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    print_summary("ARG activation / Sulfate", out["Sulfate"])
    print(f"  activated fraction: {out['activated_fraction']:.3f} "
          f"(activation onset at step {out['onset_step']})")
    return out


if __name__ == "__main__":
    main()
