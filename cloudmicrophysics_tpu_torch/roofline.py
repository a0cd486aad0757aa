"""Roofline of the fused column kernels (1M / 2M / 2M + P3) on the card.

    python -m cloudmicrophysics_tpu_torch.roofline [--ncol N] [--nlev L]
        [--p3-ncol N] [--p3-nlev L] [--device cuda|cpu] [--hbm BYTES_PER_S]

Port of ``benchmarks/roofline.py``. Each column step is timed by CUDA
events (:func:`.perf.measure`: the best and the median of three rollouts)
and set against two ceilings measured on the same card, so that each row
can name its wall:

* the **copy roof**: :func:`.kernels.roof.copy_step` (the port of the
  Pallas copy kernel) over the packed ``(7, ncol, nlev)`` 1M state, one
  read and one write of every element: the memory rate a kernel can reach
  on this card, beside the data sheet's;
* the **expf rate**: :func:`.kernels.roof.exp_chain_step`, a chain of 64
  ``expf`` per element in registers over ``ncol * nlev`` elements: what
  the special-function units and the float32 pipes around them deliver.

``wall`` is ``"hbm"`` when a step reaches 0.7 of the measured copy roof and
``"sm"`` otherwise (the work on the SMs holds it). One JSON line per row,
with the row names of ``benchmarks/ROOFLINE_TPU.json``; every row carries
the card's name and power limit as ``nvidia-smi`` prints them. The default
device is the card; without one it raises PyTorch's own error. With
``--device cpu`` every step runs once (a check of the path) and each field
that only the card can give is null.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

WALL_FRACTION = 0.7
P3_ORDER = 16    # the library default (GL-16)
# iterations per timed rollout, and rollouts (the JAX harness's counts)
N_ITER, P3_N_ITER, REPS = 20, 10, 3


def _card(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` prints them, null
    on the CPU."""
    if device.type != "cuda":
        return {"card": None, "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    return {"card": name, "power_limit": limit}


def _finite(x) -> None:
    from .perf import _leaves

    for t in _leaves(x):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("the roofline's step gave a non-finite "
                                 "result")


def _timed(step, x0, device, n_iter=N_ITER):
    """(best s, median s) per iteration on the card, over :data:`REPS`
    rollouts after one untimed call; on the CPU one call of the step,
    checked, and (None, None)."""
    from .perf import measure

    if device.type != "cuda":
        _finite(step(x0, 0.0))
        return None, None
    m = measure(step, x0, n_iter=n_iter, reps=REPS)
    _finite(m.last)
    return m.best_s, m.median_s


def _ms(seconds):
    return None if seconds is None else seconds * 1e3


def _ratio(a, b):
    return None if a is None or b is None else a / b


def _row(name, best, median, n_pts, nbytes, copy_bw, hbm_bw):
    achieved = _ratio(nbytes, best)
    frac_copy = _ratio(achieved, copy_bw)
    return {
        "metric": name,
        "ms_per_step": _ms(best),
        "ms_per_step_median": _ms(median),
        "grid_points_per_s": _ratio(n_pts, best),
        "analytic_bytes_per_step": nbytes,
        "achieved_GBps": _ratio(achieved, 1e9),
        "copy_roof_GBps": _ratio(copy_bw, 1e9),
        "fraction_of_copy_roof": frac_copy,
        "fraction_of_hbm_datasheet": _ratio(achieved, hbm_bw),
        "wall": (None if frac_copy is None
                 else "hbm" if frac_copy >= WALL_FRACTION else "sm"),
        "stat": "best-of-3 (median alongside)",
    }


def main(argv=None) -> list:
    """Run the roofline, print one JSON line per row and return the rows."""
    ap = argparse.ArgumentParser(
        prog="python -m cloudmicrophysics_tpu_torch.roofline",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncol", type=int, default=262144)
    ap.add_argument("--nlev", type=int, default=128)
    ap.add_argument("--p3-ncol", type=int, default=4096,
                    help="column count for the (much heavier) P3 step")
    ap.add_argument("--p3-nlev", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hbm", type=float, default=None,
                    help="the card's memory rate in bytes/s (default: its "
                         "data sheet's, looked up by its name)")
    cli = ap.parse_args(argv)

    from .kernels import column2m
    from .kernels import roof as R
    from .kernels.column1m import pack_state
    from .models.bench_states import (
        device_state,
        uniform_state_2m,
        uniform_state_p3,
    )
    from .models.column import Column1MStep, Column2MStep, ColumnP3Step
    from .parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        microphysics_2m_params,
        terminal_velocity_params,
    )
    from .perf import hbm_bytes_per_s

    device = torch.device(cli.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
        torch.cuda.get_device_properties(device)   # raises without a card
    card = _card(device)
    hbm_bw = (hbm_bytes_per_s(card["card"], cli.hbm)
              if device.type == "cuda" else cli.hbm)
    ncol, nlev = cli.ncol, cli.nlev
    N = ncol * nlev
    tps = ThermodynamicsParameters()
    rows = []

    # --- measured copy roof: K6 over the packed 1M state ------------------
    packed = pack_state(device_state(ncol, nlev, device))
    copy_bytes = packed.numel() * packed.element_size() * 2   # read + write
    dt_copy, dt_copy_med = _timed(
        lambda x, s: R.copy_step(x, R.scale_of(s)), packed, device)
    copy_bw = _ratio(copy_bytes, dt_copy)
    rows.append({
        "metric": "dma_copy_roof",
        "ms_per_step": _ms(dt_copy),
        "ms_per_step_median": _ms(dt_copy_med),
        "bytes_per_step": copy_bytes,
        "achieved_GBps": _ratio(copy_bw, 1e9),
        "fraction_of_hbm_datasheet": _ratio(copy_bw, hbm_bw),
        "stat": "best-of-3 (median alongside)",
    })

    # --- expf rate: the chained-exp probe at the same footprint -----------
    xe = torch.full((N,), 0.5, dtype=torch.float32, device=device)
    dt_exp, _ = _timed(lambda x, s: R.exp_chain_step(x, s, R.CHAIN), xe,
                       device)
    exp_rate = _ratio(N * R.CHAIN, dt_exp)
    rows.append({
        "metric": "vpu_exp_rate",
        "unit": "expf on the SMs",
        "exp_per_s": exp_rate,
        "ms_per_step": _ms(dt_exp),
        "chain": R.CHAIN,
        "elements": N,
    })
    del xe

    # --- 1M fused step (K1, packed, with the in-kernel q_tot affine) ------
    model1 = Column1MStep(microphysics_1m_params(), tps,
                          terminal_velocity_params(), 1.0, 100.0,
                          device=device)
    dt1, dt1m = _timed(
        lambda x, s: model1(x, q_tot_affine=(float(R.scale_of(s)), 1e-9)),
        packed, device)
    rows.append(_row("1m_step_pallas_packed", dt1, dt1m, N, 14 * 4 * N,
                     copy_bw, hbm_bw))
    del packed, model1

    # --- 2M warm-rain column step (K3 on the uniform 2M state) ------------
    model2 = Column2MStep(microphysics_2m_params(), tps, 1.0, 100.0,
                          device=device)
    st2 = column2m.pack_state_2m(uniform_state_2m(ncol, nlev, device))
    dt2, dt2m = _timed(
        lambda x, s: model2(x, q_tot_affine=(float(R.scale_of(s)), 0.0)),
        st2, device)
    rows.append(_row("2m_column_step", dt2, dt2m, N, 14 * 4 * N, copy_bw,
                     hbm_bw))
    del st2, model2

    # --- full 2M + P3 column step (K5, shape solve warm-started) ----------
    pncol, pnlev = cli.p3_ncol, cli.p3_nlev
    pN = pncol * pnlev
    model3 = ColumnP3Step(microphysics_2m_params(
        with_ice=True, quadrature_order=P3_ORDER), tps, 1.0, 100.0,
        device=device)

    def p3_step(x, s):
        st, ll = x
        return model3(st._replace(q_tot=st.q_tot * float(R.scale_of(s))),
                      ll)

    dt3, dt3m = _timed(p3_step, (uniform_state_p3(pncol, pnlev, device), None),
                       device, n_iter=P3_N_ITER)
    # 11 prognostic fields + log lambda, read + written
    rows.append(_row("p3_column_step", dt3, dt3m, pN, 12 * 4 * 2 * pN,
                     copy_bw, hbm_bw))
    rows[-1]["batch"] = [pncol, pnlev]
    rows[-1]["quadrature_order"] = P3_ORDER
    # the exp-equivalents per point the step could afford at the measured
    # expf rate
    rows[-1]["exp_equivalents_per_point_budget"] = _ratio(
        None if exp_rate is None or dt3 is None else exp_rate * dt3, pN)

    for r in rows:
        r["device"] = device.type
        r.update(card)
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
