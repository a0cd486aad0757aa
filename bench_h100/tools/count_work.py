"""Count once the work per grid point of each cell's kernels, on the card.

    python3 bench_h100/tools/count_work.py --seed 7 [cell ...]

For each cell it builds the program's step on the cell's own state (made
from ``--seed`` and stepped twice, so that the P3 shape solve is
warm-started), counts the float32 and special-function (MUFU) operations
of the timed build's SASS on its least path with the program's
``kernels/opcount.py`` (through ``chip_smoke.py``'s drivers of it: K1's
``cell_step`` per cell, with the substep loop once per substep; K5's three
kernels by the probe build's region counts on this state), and prints one
JSON line per cell with the counts per point, the bytes per point (each
input read once, each output written once) and the build they were counted
on. The numbers go into ``workloads/<cell>.json`` under ``work`` by hand,
and are never counted again.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# bytes a point moves: each float32 field read once and written once (the
# packed 1M state: 7; the P3 state: 11 fields and log lambda)
BYTES_PER_POINT = {"column_1m": 7 * 4 * 2, "column_p3": 12 * 4 * 2}


def _count_1m(cell):
    import chip_smoke
    from cloudmicrophysics_tpu_torch.kernels import column1m as K

    params = cell.module.block(cell.module.params.dtype)
    lib = K.library_path(params, variant=K.variant(cell.module.mp,
                                                   cell.mode))
    nsub = cell.nsub if cell.mode == "linearized_average" else None
    per_cell, _, _ = chip_smoke._cell_ops(K.SOURCE, lib,
                                          "column1m_step_kernel", nsub=nsub)
    return {"k1": (per_cell.flops, per_cell.mufu, lib.parent.name)}


def _count_p3(cell, carry):
    import chip_smoke
    from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5

    state, guess = carry
    chip_smoke.DT, chip_smoke.DZ = cell.dt, cell.dz
    ops, _, _ = chip_smoke._k5_ops(K5, cell.module, state, guess,
                                   cell.device, quiet=True)
    total = sum(ops.values(), type(ops["K5a"])())
    lib = K5.library_path("kernel", K5.variant(cell.module.mp))
    return {"k5": (total.flops / cell.points, total.mufu / cell.points,
                   Path(lib).parent.name)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cells", nargs="+")
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import harness

    card = torch.cuda.get_device_name(0)
    for name in args.cells:
        _, workload, config, _ = harness.load_cell(name)
        cell = harness.load_driver(config["kind"]).Cell(
            config, workload, torch.device("cuda", 0))
        carry = cell.initial(args.seed)
        for _ in range(2):
            carry = cell.step(carry)
        torch.cuda.synchronize()
        counts = (_count_1m(cell) if config["kind"] == "column_1m"
                  else _count_p3(cell, carry))
        work = {group: {"bytes_per_point": BYTES_PER_POINT[config["kind"]],
                        "flops_per_point": flops, "mufu_per_point": mufu,
                        "counted_on": {"build": build, "card": card,
                                       "seed": args.seed}}
                for group, (flops, mufu, build) in counts.items()}
        print(json.dumps({"cell": name, "work": work}), flush=True)
        del cell, carry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
