"""Frostenberg (2023) INP-climatology immersion freezing: mean / random /
stochastic variants (reference parcel/Example_Frostenberg_Immersion_Freezing.jl)."""

import math

import torch

from ..models import parcel as PM
from ..ops.ice_nucleation import INP_concentration_mean
from ..parameters.ice_nucleation import Frostenberg2023
from .common import (device_of, frozen_fraction, host, parcel_ic,
                     parse_args, print_summary, summary)

# (mode, extra options), in the script's order; all but the first draw
MODES = (("Frostenberg_mean", {}),
         ("Frostenberg_random", {"sampling_interval": 60.0}),
         ("Frostenberg_stochastic", {"gamma": 1.0}),
         ("Frostenberg_stochastic", {"gamma": 0.01}))
LABELS = tuple(f"{mode} {extra or ''}" for mode, extra in MODES)


def setup(device, dtype=torch.float64):
    """The initial state and each variant's ``(label, parameters)``."""
    ip = Frostenberg2023()
    N_l, r0 = 500e3, 1e-6
    T0 = 251.0
    q_l = N_l * 4 / 3 * math.pi * r0**3 * 1000.0 / 1.2
    ln_inpc0 = float(INP_concentration_mean(ip, host(T0)))
    ic = parcel_ic(800e2, T0, 8.1e-4, q_l, 0.0, 0.0, N_l, 0.0,
                   ln_inpc=ln_inpc0, device=device, dtype=dtype)
    common = dict(condensation_growth="Condensation",
                  deposition_growth="Deposition", const_dt=1.0, w=0.7)
    return ic, [(label, PM.parcel_params(heterogeneous=mode, **common,
                                         **extra))
                for (mode, extra), label in zip(MODES, LABELS)]


def numbers(traj):
    """A variant's summary and its frozen fraction at the end."""
    return dict(summary(traj), ff_end=float(frozen_fraction(traj)[-1]))


def run(device=None, dtype=torch.float64, t_end=1200.0, seed=0):
    """The four variants' summaries and frozen fractions at the end, keyed
    by the script's label. Each random variant draws from its own
    ``torch.Generator`` on ``device`` seeded ``seed`` (the JAX script
    leaves ``run_parcel`` its default key, 0)."""
    device = device_of(device)
    ic, runs = setup(device, dtype)
    out = {"steps": 0}
    for label, params in runs:
        rng = (torch.Generator(device=device).manual_seed(seed)
               if params.heterogeneous != "Frostenberg_mean" else None)
        traj = PM.run_parcel(ic, 0.0, t_end, params, rng_key=rng)
        out["steps"] += traj.S_l.shape[0] - 1
        out[label] = numbers(traj)
    return out


def main(argv=None):
    cli = parse_args(__doc__, argv)
    out = run(cli.device)
    for label in LABELS:
        print_summary(label, out[label])
        print(f"  frozen fraction end: {out[label]['ff_end']:.3e}")
    return out


if __name__ == "__main__":
    main()
