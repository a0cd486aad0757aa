"""The readings that a cell's limits are set from, on the card.

    python3 bench_h100/tools/readings.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--host-columns 128]

For each seed, in one process: the cell's run as the benchmark makes it
(its own size, the start step, the warm-up, a closed-loop window of
``--seconds``), then, over the same checked steps and columns and against
the same reference, the numbers of the workload's ``check`` at each of
``--tolerances`` for

* ``program``: the program's answers (a lower reading);
* ``host``: the reference in the configuration's precision on the host's
  CPU, a sound program whose every operation rounds otherwise (another
  library's exp, log and pow, other summation orders), over the first
  ``--host-columns`` checked columns (a lower reading);
* ``float64``, with ``--float64``: the reference in float64 (for the
  record);
* ``control``: the reference in bfloat16, the precision below the
  configuration's float32 (an upper reading);
* the faults a column cell can have: ``unchanged`` (a step that returns
  its input state; P3 with the step's log lambda), ``half`` (the columns
  from the middle on left as they were) and ``altered`` (one checked
  column's answers 10 % off);

and ``episode_nonfinite_steps``, the steps of one whole episode from the
seeded state whose state is not finite everywhere. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TOLERANCES = (1e-5, 1e-4, 1e-3, 1e-2)


def _replace_state(kind, carry_in, carry_out):
    """The carry_out with its state replaced by carry_in's."""
    if kind == "column_1m":
        return carry_in
    return carry_in[0], carry_out[1]


def _host_carry(kind, carry, cols):
    """The columns ``cols`` of ``carry``, on the host."""
    if kind == "column_1m":
        return carry[:, cols].cpu()
    state, guess = carry
    return (type(state)(*(f[cols].cpu() for f in state)),
            None if guess is None else guess[cols].cpu())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--tolerances", type=float, nargs="+",
                        default=list(TOLERANCES))
    parser.add_argument("--host-columns", type=int, default=128)
    parser.add_argument("--float64", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ncol", type=int, default=None,
                        help="columns instead of the grid's (rehearsal)")
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import check, harness

    _, workload, config, _ = harness.load_cell(args.workload)
    kind = config["kind"]
    dtype = check.DTYPES[config["reference_dtype"]]
    spec = workload["check"]
    device = torch.device("cuda:0" if args.device == "cuda" else args.device)
    for seed in args.seeds:
        cell = harness.load_driver(kind).Cell(config, workload, device,
                                              args.ncol)
        episode = int(workload["step"].get("episode_steps", 0))
        w = harness.drive(cell, cell.step, seed, args.seconds, False,
                          time.perf_counter(), episode)
        carry = cell.restart(w.kept["start"][0], w.kept["start"][1])
        nonfinite_steps = 0
        for _ in range(episode or w.steps):
            carry = cell.step(carry)
            nonfinite_steps += not cell.finite(carry)
        del carry

        columns = check.sample_columns(cell.ncol, spec.get("columns"), seed)
        host_cols = set(columns[:args.host_columns].tolist())
        block = int(spec["block_columns"])
        scales = cell.scales(w.kept["start"][0])
        names = ("program", "host", "control", "unchanged", "half",
                 "altered") + (("float64",) if args.float64 else ())
        accs = {(n, t): check.GapSum(
            cell.groups, {g: t for g in cell.groups}, scales)
            for n in names for t in args.tolerances}
        t0 = time.perf_counter()
        check_s = 0.0
        for c_in, c_out in w.kept.values():
            still = _replace_state(kind, c_in, c_out)
            for lo in range(0, len(columns), block):
                cols = columns[lo:lo + block].to(device)
                with torch.no_grad():
                    t1 = time.perf_counter()
                    ref = cell.reference(c_in, cols, dtype)
                    out = cell.answers(c_out, cols)
                    check_s += time.perf_counter() - t1
                    cands = {
                        "program": out,
                        "control": cell.reference(c_in, cols,
                                                  torch.bfloat16),
                        "unchanged": cell.answers(still, cols),
                    }
                    if args.float64:
                        cands["float64"] = cell.reference(c_in, cols,
                                                          torch.float64)
                    upper = cols >= cell.ncol // 2
                    cands["half"] = torch.where(upper[None, :, None],
                                                cands["unchanged"], out)
                    altered = out.clone()
                    if lo == 0:
                        altered[:, 0] *= 1.1
                    cands["altered"] = altered
                    mine = [i for i, c in enumerate(cols.tolist())
                            if c in host_cols]
                    for t in args.tolerances:
                        for n, c in cands.items():
                            accs[(n, t)].add(c, ref)
                    if mine:
                        host = _host_carry(kind, c_in, cols[mine])
                        h = cell.reference(host, torch.arange(len(mine)),
                                           dtype).to(device)
                        for t in args.tolerances:
                            accs[("host", t)].add(h, ref[:, mine])
                    del ref, out, cands
        total_s = time.perf_counter() - t0
        readings = {n: {str(t): accs[(n, t)].gaps() for t in args.tolerances}
                    for n in names}
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "steps": w.steps, "check_s": check_s,
                          "readings_s": total_s,
                          "readings": readings,
                          "episode_nonfinite_steps": nonfinite_steps,
                          "card": (torch.cuda.get_device_name(0)
                                   if device.type == "cuda" else "cpu")}),
              flush=True)
        del cell, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
