"""Alpert & Knopf (2016) immersion-freezing box model, Cr1 case
(reference box/Alpert_Knopf_2016_forward.jl): deterministic uniform-area
ABIFM vs stochastic per-droplet freezing with a lognormal INP surface-area
distribution."""

import numpy as np
import torch

from ..models.box import BoxState, run_box, run_box_stochastic
from ..parameters.aerosol_species import Illite
from .common import TPS, device_of, parse_args, to_numpy

A_AERO = 1e-5 * 1e-4     # INP surface area per droplet [m^2]
SIGMA_G, N0 = 10.0, 1000


def surface_areas(n=N0, seed=42):
    """The script's per-droplet surface areas: ``n`` lognormal draws of
    numpy's ``default_rng(seed)``, largest first."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.lognormal(np.log(A_AERO), np.log(SIGMA_G),
                                 n))[::-1].copy()


def run(device=None, dtype=torch.float64, t_end=3310.0, seed=7):
    """Both boxes: the deterministic one's temperatures and frozen
    fraction, the stochastic one's frozen fraction (its uniforms from a
    ``torch.Generator`` on ``device`` seeded ``seed``, where the script
    uses ``PRNGKey(7)``), and the step at which each is half frozen."""
    device = device_of(device)
    T0, cooling = 256.0, 0.5 / 60
    dt = 10.0
    ic = BoxState(*(torch.tensor(v, dtype=dtype, device=device)
                    for v in (T0, N0 * A_AERO, float(N0), 0.0)))
    traj = run_box(ic, 0.0, t_end, TPS, Illite(), cooling, A_AERO, dt)
    Aj = torch.tensor(surface_areas(), dtype=dtype, device=device)
    T_t, N_liq_t, N_ice_t, _ = run_box_stochastic(
        T0, Aj, 0.0, t_end, TPS, Illite(), cooling, dt,
        torch.Generator(device=device).manual_seed(seed))
    N_ice_det, N_ice_sto = to_numpy(traj.N_ice), to_numpy(N_ice_t)
    return {"steps": traj.T.shape[0] - 1 + T_t.shape[0],
            "T_start": float(traj.T[0]), "T_end": float(traj.T[-1]),
            "ff_det": float(N_ice_det[-1] / N0),
            "ff_sto": float(N_ice_sto[-1] / N0),
            # KA16's point: broad surface-area distributions freeze
            # earlier (large-A droplets) but saturate slower (small-A tail
            # survives)
            "half_det": int(np.argmax(N_ice_det >= N0 / 2)),
            "half_sto": int(np.argmax(N_ice_sto >= N0 / 2))}


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    print("== deterministic (uniform A) ==")
    print(f"  T: {out['T_start']:.1f} -> {out['T_end']:.1f} K")
    print(f"  frozen fraction: {out['ff_det']:.3f}")
    print("== stochastic (lognormal A, sigma_g=10) ==")
    print(f"  frozen fraction: {out['ff_sto']:.3f}")
    print(f"  50% frozen at step: det={out['half_det']}, "
          f"stochastic={out['half_sto']}")
    return out


if __name__ == "__main__":
    main()
