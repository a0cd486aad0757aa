"""P3-scheme ice nucleation modes (dep / het / hom)
(reference parcel/Example_P3_ice_nuc.jl)."""

import math

import torch

from ..models import parcel as PM
from ..parameters.aerosol_species import Illite
from .common import device_of, parcel_ic, parse_args, print_summary, summary

RUNS = (("P3_dep", 235.0, dict(deposition="P3_dep")),
        ("P3_het", 235.0, dict(heterogeneous="P3_het", aerosol=Illite)),
        ("P3_hom", 233.2, dict(homogeneous="P3_hom")))


def run(device=None, dtype=torch.float64, t_end=50.0):
    """Each P3 mode's summary and its ICNC at the end in cm^-3."""
    device = device_of(device)
    N_a, N_l, r_l = 2000.0, 2000.0, 1.25e-6
    p0, q_v = 20000.0, 5e-4
    q_l = N_l * 4 / 3 * math.pi * r_l**3 * 1000.0 / 1.2
    out = {"steps": 0}
    for name, T0, sel in RUNS:
        sel = {k: (v() if k == "aerosol" else v) for k, v in sel.items()}
        ic = parcel_ic(p0, T0, q_v, q_l, 0.0, N_a, N_l, 0.0, device=device,
                       dtype=dtype)
        params = PM.parcel_params(
            deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=0.5, **sel)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += traj.S_l.shape[0] - 1
        s = summary(traj)
        out[name] = dict(s, icnc_end=s["N_ice"] / 1e6)
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for name, _, _ in RUNS:
        print_summary(f"P3 nucleation / {name}", out[name])
        print(f"  ICNC end = {out[name]['icnc_end']:.3e} cm^-3")
    return out


if __name__ == "__main__":
    main()
