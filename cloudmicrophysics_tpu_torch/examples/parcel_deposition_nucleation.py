"""Deposition nucleation on dust in a cirrus-like parcel
(reference parcel/Example_Deposition_Nucleation.jl)."""

import torch

from ..models import parcel as PM
from ..parameters.aerosol_species import (
    ArizonaTestDust,
    DesertDust,
    Feldspar,
    Ferrihydrite,
    Kaolinite,
)
from .common import device_of, parcel_ic, parse_args, print_summary, summary

RUNS = ([("MohlerRate", a) for a in (DesertDust, ArizonaTestDust)]
        + [("ABDINM", a) for a in (Feldspar, Ferrihydrite, Kaolinite)])


def run(device=None, dtype=torch.float64, t_end=100.0):
    """MohlerRate on two dusts and ABDINM on three: each run's summary,
    keyed ``"<mode> / <species>"``."""
    device = device_of(device)
    ic = parcel_ic(20000.0, 230.0, 3.3e-4, 0.0, 0.0, 2000e3, 0.0, 0.0,
                   device=device, dtype=dtype)
    out = {"steps": 0}
    for mode, aero in RUNS:
        params = PM.parcel_params(
            aerosol=aero(), deposition=mode, deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=3.5e-2)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += traj.S_l.shape[0] - 1
        out[f"{mode} / {aero.__name__}"] = summary(traj)
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for mode, aero in RUNS:
        label = f"{mode} / {aero.__name__}"
        print_summary(label, out[label])
    return out


if __name__ == "__main__":
    main()
