"""P3 (Morrison-Milbrandt 2015) nucleation vs water-activity-based
parameterizations (reference parcel/Example_P3_vs_activitybased.jl):
P3_dep vs ABDINM, P3_het vs ABIFM, P3_hom vs ABHOM."""

import math

import torch

from ..models import parcel as PM
from ..parameters.aerosol_species import (
    DesertDust,
    Feldspar,
    Ferrihydrite,
    Illite,
    Kaolinite,
)
from .common import device_of, parcel_ic, parse_args

T_DEP, T_HET, T_HOM = 238.0, 239.0, 236.5
# (group, label, T0, selection), in the script's order
RUNS = (
    [("deposition", "P3_dep", T_DEP, dict(deposition="P3_dep"))]
    + [("deposition", f"ABDINM {a.__name__}", T_DEP,
        dict(deposition="ABDINM", aerosol=a, A_aer=1e-10))
       for a in (Feldspar, Ferrihydrite, Kaolinite)]
    + [("immersion", "P3_het", T_HET, dict(heterogeneous="P3_het"))]
    + [("immersion", f"ABIFM {a.__name__}", T_HET,
        dict(heterogeneous="ABIFM", aerosol=a,
             condensation_growth="Condensation"))
       for a in (DesertDust, Illite, Kaolinite)]
    + [("homogeneous", "P3_hom", T_HOM, dict(homogeneous="P3_hom")),
       ("homogeneous", "ABHOM", T_HOM, dict(homogeneous="ABHOM"))])
HEADERS = {"deposition": "deposition:  P3_dep vs ABDINM",
           "immersion": "immersion:   P3_het vs ABIFM",
           "homogeneous": "homogeneous: P3_hom vs ABHOM"}


def run(device=None, dtype=torch.float64, t_end=50.0):
    """N_ice at the end of each of the ten runs, keyed by its label."""
    device = device_of(device)
    N_a, N_l, r_l = 2000.0, 2000.0, 1.25e-6
    p0, q_v = 20000.0, 8.3e-4
    q_l = N_l * 4 / 3 * math.pi * r_l**3 * 1000.0 / 1.2
    out = {"steps": 0}
    for _, label, T0, sel in RUNS:
        sel = {k: (v() if k == "aerosol" else v) for k, v in sel.items()}
        ic = parcel_ic(p0, T0, q_v, q_l, 0.0, N_a, N_l, 0.0, device=device,
                       dtype=dtype)
        params = PM.parcel_params(
            deposition_growth="Deposition",
            ice_size_distribution="Monodisperse",
            r_nuc=1.25e-6, const_dt=0.1, w=0.5, **sel)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        out["steps"] += traj.S_l.shape[0] - 1
        out[label] = float(traj.N_ice[-1])
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    group = None
    for g, label, _, _ in RUNS:
        if g != group:
            group = g
            print(f"== {HEADERS[g]} ==")
        if label.startswith("P3") or label == "ABHOM":
            print(f"  {label:20s}N_ice = {out[label]:.3e}")
        else:
            mode, species = label.split()
            print(f"  {mode:6s} {species:13s} N_ice = {out[label]:.3e}")
    return out


if __name__ == "__main__":
    main()
