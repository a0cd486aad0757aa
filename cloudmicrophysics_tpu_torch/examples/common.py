"""Shared helpers of the examples (the JAX package's ``examples/common.py``,
reference ``parcel/ParcelCommon.jl``).

Each example re-runs one of the reference's validation cases with the
JAX script's initial conditions and process selection. Its ``run()``
returns the numbers the script prints, unrounded, as a dict; its
``main()`` prints the script's lines with the script's format strings.
Everything runs on ``device``: CUDA unless another device is asked for.
There is no fallback: without a card the default device raises PyTorch's
own error at the first tensor placed on it.

The initial conditions are computed on the host in float64, as the JAX
scripts compute them at x64, and placed on the device in the run's dtype.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import parcel as PM
from ..ops import thermo as TDI
from ..parameters import ThermodynamicsParameters

__all__ = ["TPS", "device_of", "host", "parcel_ic", "vapor_mixing_to_q",
           "frozen_fraction", "summary", "print_summary", "parse_args",
           "timed", "to_numpy"]

TPS = ThermodynamicsParameters()


def device_of(device=None) -> torch.device:
    """``device``, CUDA when none is given."""
    return torch.device("cuda" if device is None else device)


def host(x) -> torch.Tensor:
    """A host float64 scalar tensor of ``x``."""
    return torch.tensor(float(x), dtype=torch.float64)


def parcel_ic(p_air, T, q_vap, q_liq, q_ice, N_aer, N_liq, N_ice,
              ln_inpc=0.0, tps=TPS, *, device, dtype=torch.float64):
    """Initial :class:`ParcelState` from primitive variables (reference
    parcel examples' ``get_initial_condition`` wrapper), each field a
    scalar tensor."""
    q_tot = q_vap + q_liq + q_ice
    R_a = (tps.R_d * (1 - q_tot) + tps.R_v * q_vap)
    e_sl = TDI.saturation_vapor_pressure_over_liquid(tps, host(T))
    e = q_vap * p_air * tps.R_v / R_a
    fields = dict(S_l=e / e_sl, p_air=p_air, T=T, q_vap=q_vap, q_liq=q_liq,
                  q_ice=q_ice, N_aer=N_aer, N_liq=N_liq, N_ice=N_ice,
                  ln_inpc=ln_inpc)
    return PM.ParcelState(**{k: torch.tensor(float(v), dtype=dtype,
                                             device=device)
                             for k, v in fields.items()})


def vapor_mixing_to_q(c_v, tps=TPS):
    """Vapor volume mixing ratio -> specific content
    (reference Example_Jensen_et_al_2022.jl:28-31)."""
    eps_m = tps.R_d / tps.R_v
    return eps_m / (eps_m - 1 + 1 / c_v)


def frozen_fraction(traj):
    tot = torch.clamp(traj.N_liq + traj.N_ice, min=1.0)
    return traj.N_ice / tot


def summary(traj) -> dict:
    """The numbers the JAX script's ``summarize`` prints: the end state,
    the peak supersaturation and the step of the peak."""
    end = {k: float(getattr(traj, k)[-1])
           for k in ("S_l", "T", "q_liq", "q_ice", "N_liq", "N_ice")}
    return dict(end, peak_S=float(traj.S_l.max()) - 1,
                peak_step=int(torch.argmax(traj.S_l)))


def print_summary(name, s):
    print(f"== {name} ==")
    print(f"  t_end: S_l={s['S_l']:.4f} "
          f"T={s['T']:.2f} K "
          f"q_liq={s['q_liq']:.3e} "
          f"q_ice={s['q_ice']:.3e} "
          f"N_liq={s['N_liq']:.3e} "
          f"N_ice={s['N_ice']:.3e}")
    print(f"  peak supersaturation S_l-1 = "
          f"{s['peak_S']:.4%} at "
          f"t={float(s['peak_step'])} steps")


def parse_args(doc, argv=None, parser=None):
    """The examples' command line: ``--device`` (CUDA unless given)."""
    ap = parser or argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def timed(fn, device):
    """(wall seconds, result) of ``fn()``, waiting for ``device``."""
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def to_numpy(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()
