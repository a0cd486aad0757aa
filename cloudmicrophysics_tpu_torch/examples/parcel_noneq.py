"""Non-equilibrium condensation/deposition growth
(reference parcel/Example_NonEq.jl)."""

import math

import torch

from ..models import parcel as PM
from ..ops import thermo as TDI
from .common import (TPS, device_of, host, parcel_ic, parse_args,
                     print_summary, summary)

TAUS = (0.01, 0.1, 1.0)


def run(device=None, dtype=torch.float64, t_end=20.0):
    """Each relaxation time's summary, keyed ``"tau=<tau>"``."""
    device = device_of(device)
    N_l, N_i = 200e6, 1e6
    r_l, r_i = 1e-6, 8e-6
    p0, T0 = 800e2, 243.0
    e = float(TDI.saturation_vapor_pressure_over_liquid(TPS, host(T0)))
    md = (p0 - e) / TPS.R_d / T0
    mv = e / TPS.R_v / T0
    ml = N_l * 4 / 3 * math.pi * 1000.0 * r_l**3
    mi = N_i * 4 / 3 * math.pi * 916.7 * r_i**3
    mt = md + mv + ml + mi
    ic = parcel_ic(p0, T0, mv / mt, ml / mt, mi / mt, 0.0, N_l, N_i,
                   device=device, dtype=dtype)
    out = {"steps": 0}
    for tau in TAUS:
        params = PM.parcel_params(
            condensation_growth="NonEq_Condensation",
            deposition_growth="NonEq_Deposition_simple",
            noneq_tau=tau, const_dt=0.001, w=1.0)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += traj.S_l.shape[0] - 1
        out[f"tau={tau}"] = summary(traj)
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for tau in TAUS:
        print_summary(f"NonEq growth / tau={tau}", out[f"tau={tau}"])
    return out


if __name__ == "__main__":
    main()
