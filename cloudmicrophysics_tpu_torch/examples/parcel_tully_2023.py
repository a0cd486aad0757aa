"""Three-period cirrus simulation following Tully et al. (2023)
(reference parcel/Example_Tully_et_al_2023.jl): three 30-minute large-scale
steps, re-initializing T and q_vap between periods, MohlerAF vs MohlerRate
deposition nucleation on desert dust."""

import torch

from ..models import parcel as PM
from ..parameters.aerosol_species import DesertDust
from .common import device_of, parcel_ic, parse_args

MODES = ("MohlerAF", "MohlerRate")


def run(device=None, dtype=torch.float64, t_max=30 * 60.0):
    """Each mode's three chained periods of ``t_max`` seconds: N_ice at
    each period's start and end and its peak S_l, as a list of dicts."""
    device = device_of(device)
    N_aer = 2000e3
    p0, T0, qv0 = 20000.0, 230.0, 3.3e-4
    T2, T3 = 229.25, 228.55
    out = {"steps": 0}
    for mode in MODES:
        params = PM.parcel_params(
            aerosol=DesertDust(), deposition=mode,
            deposition_growth="Deposition",
            liq_size_distribution="Monodisperse",
            r_nuc=0.5e-4 * 1e-6, const_dt=0.1, w=3.5e-2)
        ic = parcel_ic(p0, T0, qv0, 0.0, 0.0, N_aer, 0.0, 0.0,
                       device=device, dtype=dtype)
        periods = []
        for i, T_next in enumerate((T2, T3, None)):
            tr = PM.run_parcel(ic, i * t_max, (i + 1) * t_max, params)
            out["steps"] += tr.S_l.shape[0] - 1
            periods.append({"N_ice_start": float(tr.N_ice[0]),
                            "N_ice_end": float(tr.N_ice[-1]),
                            "peak_S_l": float(tr.S_l.max())})
            if T_next is not None:
                # the next period: reset T and q_vap, keep p, q_ice and the
                # numbers from this one's end
                ic = parcel_ic(float(tr.p_air[-1]), T_next, qv0, 0.0,
                               float(tr.q_ice[-1]), float(tr.N_aer[-1]),
                               float(tr.N_liq[-1]), float(tr.N_ice[-1]),
                               device=device, dtype=dtype)
        out[mode] = periods
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for mode in MODES:
        print(f"== Tully 2023 / {mode} ==")
        for i, p in enumerate(out[mode], 1):
            print(f"  period {i}: N_ice {p['N_ice_start']:.3e} -> "
                  f"{p['N_ice_end']:.3e} 1/m^3, "
                  f"peak S_l = {p['peak_S_l']:.4f}")
    return out


if __name__ == "__main__":
    main()
