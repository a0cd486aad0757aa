"""Count once the work per grid point of the P3 tendency call, on the card.

    python3 bench_h100/tools/count_work_p3tend.py --seed 7 [--chunks 4]

For the cell ``p3_tend_gl40`` it makes the cell's state from ``--seed``
and steps it twice, so that the host's shape solve is warm-started and the
state is one the window meets; then runs the three kernels of the tendency
build of ``column_p3.cu`` (``-DK5_TEND``: the bounds kernel, K5b's node
pass, the rates kernel) on the step's input through the build's probe
(``-DK5_TEND -DK5_PROBE``), a chunk of columns at a time (``--chunks``: the
probe keeps a counter a thread and a region), and multiplies each region's
executions by its float32 and special-function (MUFU) operations on its
least path through the timed build's SASS (``kernels/opcount.py``, as
``tools/count_work.py`` counts K5). It prints one JSON line with the
counts per point, the bytes per point (the eleven fields, log lambda and
the INP shift read once, the eight rates written once) and the build they
were counted on. The numbers go into ``workloads/p3_tend_gl40.json`` under
``work`` by hand, and are never counted again.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CELL = "p3_tend_gl40"
# bytes a point moves at float32: 13 inputs read, 8 rates written
BYTES_PER_POINT = (11 + 2 + 8) * 4


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--chunks", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import harness
    from cloudmicrophysics_tpu_torch.kernels import _build, opcount
    from cloudmicrophysics_tpu_torch.kernels import column_p3 as K

    device = torch.device("cuda", 0)
    _, workload, config, _ = harness.load_cell(CELL)
    cell = harness.load_driver(config["kind"]).Cell(config, workload, device)
    carry = cell.initial(args.seed)
    for _ in range(2):
        carry = cell.step(carry)
    state, guess = carry
    fields = K.ColumnStateP3(*state[:11])
    loglam = K.loglambda_p3_fused(fields, cell.mp, cell.tps, guess)
    torch.cuda.synchronize()

    mp, dtype = cell.mp, cell.dtype
    v = K.variant(mp, dtype)
    src = (_build.CSRC_DIR / K.SOURCE).read_text()
    names = opcount.region_names(src)
    sites = opcount.probe_sites(src, K.probe_unrolls(v))
    plib = K._library("tend_probe", v)
    if plib.column_p3_probe_regions() != len(names):
        raise AssertionError("probe build with another region list")
    params = K.kernel_params_p3(mp, cell.tps, device=device, dtype=dtype)
    warm = K.warm_variant(mp)
    counts = {k: dict.fromkeys(names, 0) for k in ("K5a", "K5b", "K5c")}
    ncol = cell.ncol
    step = -(-ncol // args.chunks)
    for lo in range(0, ncol, step):
        sl = slice(lo, min(lo + step, ncol))
        flat = K.ColumnStateP3(*(f[sl].reshape(-1) for f in fields))
        ll = loglam[sl].reshape(-1).contiguous()
        shift = state.inpc_log_shift[sl].reshape(-1).contiguous()
        n = flat.rho.numel()
        plan = K.launch_plan(n, 1, mp.ice.quad.n, 1, dtype)
        scratch = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
        out = torch.empty((len(K.TEND_FIELDS), n), dtype=dtype, device=device)
        calls = {
            "K5a": (plan.solve_grid * K.SOLVE_THREADS,
                    lambda: K.launch_tend_bounds(plib, flat, ll, scratch,
                                                 params, plan, device)),
            "K5b": (plan.nodes_grid * K.NODE_THREADS,
                    lambda: K.launch_nodes(plib, flat, scratch, params, plan,
                                           device)),
            "K5c": (-(-n // K.EPILOGUE_THREADS) * K.EPILOGUE_THREADS,
                    lambda: K.launch_tend_rates(plib, flat, shift, out,
                                                scratch, params, warm,
                                                device)),
        }
        for key, (threads, fn) in calls.items():
            buf = torch.zeros((2 * len(names), threads), dtype=torch.int32,
                              device=device)
            err = plib.column_p3_probe_set(buf.data_ptr(), threads,
                                           device.index)
            if err:
                raise RuntimeError(f"column_p3_probe_set: CUDA error {err}")
            fn()
            sums = buf[:len(names)].sum(dim=1, dtype=torch.int64).tolist()
            for name, c in zip(names, sums):
                counts[key][name] += c
            del buf
        del scratch, out, flat

    lib = K.library_path("tend", v)
    sass = opcount.disassemble(lib)
    limited, chen = warm
    instrs = [i for i in opcount.parse_sass(sass)
              if "tend_rates_kernel" not in i.function
              or f"ILb{limited}ELb{chen}E" in i.function]
    per, _, _, lost = opcount.region_tallies(instrs, sites, K.SOURCE)
    total = opcount.Tally()
    per_kernel = {}
    for key, c in counts.items():
        tally = sum(opcount.dynamic_count(per, c, sites).values(),
                    opcount.Tally())
        per_kernel[key] = {"flops": tally.flops, "mufu": tally.mufu,
                           "regions": {n: x for n, x in c.items() if x}}
        total = total + tally
    points = cell.points
    print(f"{len(instrs)} SASS instructions of the timed build (the launched "
          f"variants), {lost} in slow paths or outside every region; per "
          f"kernel {json.dumps(per_kernel)}", file=sys.stderr)
    work = {"p3tend": {
        "bytes_per_point": BYTES_PER_POINT,
        "flops_per_point": total.flops / points,
        "mufu_per_point": total.mufu / points,
        "counted_on": {"build": Path(lib).parent.name,
                       "card": torch.cuda.get_device_name(0),
                       "seed": args.seed,
                       "tool": "bench_h100/tools/count_work_p3tend.py "
                               "(kernels/opcount.py least path)"}}}
    print(json.dumps({"cell": CELL, "work": work}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
