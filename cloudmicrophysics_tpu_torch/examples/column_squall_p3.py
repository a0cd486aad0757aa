"""Idealized mixed-phase column with the full 2M warm rain + P3 ice step.

A supersaturated mid-level cloud layer over a sub-cloud layer, stepped
with the shape solve warm-started between steps. Prints a compact budget
every ``nsteps // 6`` steps and the final water paths, the host-model
usage pattern (reference ``test/gpu_clima_core_test.jl:34-40`` role, here
with ice).

On CUDA the column steps with :class:`ColumnP3Step`, the three kernels of
``kernels/column_p3.py``, which tile the columns themselves, so
``--col-chunks`` is refused there. On the CPU it steps with the plain
:func:`step_column_p3`, ``--col-chunks`` evaluating each step over that
many column chunks (``perf.chunked_cells``).

Run: ``python -m cloudmicrophysics_tpu_torch.examples.column_squall_p3
[--ncol 256] [--nlev 64] [--nsteps 120] [--order 8] [--device cpu]``
"""

import argparse

import numpy as np
import torch

from ..models.column import ColumnP3Step, ColumnStateP3, step_column_p3
from ..parameters import microphysics_2m_params
from .common import TPS, device_of, parse_args


def column_state(ncol, nlev, dz, device, dtype=torch.float32):
    """The script's initial columns, every column the same: T decreasing
    with height through freezing, a liquid cloud layer in the lower
    middle, ice aloft."""
    z = np.linspace(0.0, dz * (nlev - 1), nlev)
    T_prof = 292.0 - 7.0e-3 * z                      # through 0 C mid-column
    rho_prof = 1.2 * np.exp(-z / 8500.0)
    cloud = np.exp(-((z - 2500.0) / 900.0) ** 2)      # liquid layer
    anvil = np.exp(-((z - 9000.0) / 1500.0) ** 2)     # ice layer

    def tile(p):
        # rounded to float32 first, as the script's tiles are
        p = torch.tensor(np.asarray(p, np.float32), device=device)
        return p.to(dtype).expand(ncol, nlev).contiguous()

    return ColumnStateP3(
        rho=tile(rho_prof), T=tile(T_prof),
        q_tot=tile(9e-3 * np.exp(-z / 3000.0)),
        q_lcl=tile(1.2e-3 * cloud), n_lcl=tile(1.0e8 * cloud),
        q_rai=tile(2e-4 * cloud), n_rai=tile(8e5 * cloud),
        q_ice=tile(6e-4 * anvil), n_ice=tile(1.2e5 * anvil),
        q_rim=tile(1.5e-4 * anvil), b_rim=tile(3e-7 * anvil),
    )


def stepper(mp, dt, dz, device, col_chunks=None):
    """``step(state, guess) -> (state, loglambda)``: the kernels on CUDA,
    the plain step elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        if col_chunks is not None:
            raise ValueError("col_chunks applies to the plain step only: "
                             "on CUDA the kernels tile the columns "
                             "themselves")
        return ColumnP3Step(mp, TPS, dt, dz, device=device)
    return lambda s, g: step_column_p3(s, mp, TPS, dt, dz, g,
                                       col_chunks=col_chunks)


def water_paths(state, dz):
    """Column 0's liquid, rain and ice water paths [kg/m^2]."""
    return tuple(float(torch.sum(state.rho[0] * q[0]) * dz)
                 for q in (state.q_lcl, state.q_rai, state.q_ice))


def rollout(state, step, nsteps, dz, guess=None):
    """``nsteps`` steps of ``step`` carrying log lambda as the next step's
    guess. Returns the final state, its log lambda and the script's table
    rows ``[step, LWP, RWP, IWP, T_sfc]``."""
    rows = []
    for i in range(nsteps):
        state, guess = step(state, guess)
        if i % max(nsteps // 6, 1) == 0 or i == nsteps - 1:
            rows.append([i, *water_paths(state, dz),
                         float(state.T[0, 0])])
    return state, guess, rows


def run(device=None, dtype=torch.float32, ncol=256, nlev=64, nsteps=120,
        dt=2.0, dz=250.0, order=8, col_chunks=None):
    """The table rows, the final water paths of column 0 and the rime
    fraction of the whole domain. Raises if a field is not finite."""
    device = device_of(device)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    step = stepper(mp, dt, dz, device, col_chunks)
    st, _, rows = rollout(column_state(ncol, nlev, dz, device, dtype), step,
                          nsteps, dz)
    for name, leaf in zip(st._fields, st):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name} is not finite")
    lwp, rwp, iwp = water_paths(st, dz)
    return {"steps": nsteps, "rows": rows, "LWP": lwp, "RWP": rwp,
            "IWP": iwp, "rime_fraction": float(
                torch.sum(st.q_rim) / torch.clamp(torch.sum(st.q_ice),
                                                  min=1e-12))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ncol", type=int, default=256)
    ap.add_argument("--nlev", type=int, default=64)
    ap.add_argument("--nsteps", type=int, default=120)
    ap.add_argument("--dt", type=float, default=2.0)
    ap.add_argument("--dz", type=float, default=250.0)
    ap.add_argument("--order", type=int, default=8)
    ap.add_argument("--col-chunks", type=int, default=None,
                    help="evaluate the plain step over N ncol chunks "
                    "(perf.chunked_cells; CPU only)")
    cli = parse_args(__doc__, argv, ap)
    out = run(cli.device, ncol=cli.ncol, nlev=cli.nlev, nsteps=cli.nsteps,
              dt=cli.dt, dz=cli.dz, order=cli.order,
              col_chunks=cli.col_chunks)
    print(f"{'step':>5s} {'LWP[kg/m2]':>11s} {'RWP':>8s} {'IWP':>8s} "
          f"{'T_sfc[K]':>9s}")
    for i, lwp, rwp, iwp, t_sfc in out["rows"]:
        print(f"{i:5d} {lwp:11.5f} {rwp:8.5f} {iwp:8.5f} {t_sfc:9.2f}")
    print(f"final column-0 budgets: LWP={out['LWP']:.5f} "
          f"RWP={out['RWP']:.5f} IWP={out['IWP']:.5f} "
          f"rime fraction={out['rime_fraction']:.3f}")
    return out


if __name__ == "__main__":
    main()
