"""How long a cell's closed loop stays in the regime it starts in, on the
card: the measurement behind each workload's ``episode_steps``.

    python3 bench_h100/tools/regime.py --workload <cell> --seed <n> \
        --steps 2000 --every 50 [--dt 60 450] [--episodes 0 50 100] \
        [--seconds 6]

Prints one JSON line for each of

* ``rollout``: ``--steps`` steps from the seeded state with no restart,
  in blocks of ``--every``: each block's mean step time by CUDA events,
  whether the state is still finite, and each field's mean over the grid
  (the temperature's change in K; every other field's mean over its mean
  in the seeded state);
* ``dt``: for each ``--dt``, the same step at that time step from the
  seeded state, and the first step whose state is not finite everywhere
  (None within ``--steps``);
* ``episodes``: for each of ``--episodes`` (0: no restart), a window of
  ``--seconds`` as the benchmark drives it, and its ``points_per_s`` and
  ``step_ms_p95``.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _state(carry):
    return carry if hasattr(carry, "dim") else carry[0]


def _means(carry):
    import torch

    state = _state(carry)
    fields = state.unbind(0) if torch.is_tensor(state) else tuple(state)
    return [float(f.double().mean()) for f in fields]


def _rollout(cell, seed, steps, every):
    from bench_h100 import harness

    carry = cell.initial(seed)
    start = _means(carry)
    blocks, t_index = [], 1
    for first in range(0, steps, every):
        clock = harness.Clock(cell.device)
        clock.mark()
        for _ in range(every):
            carry = cell.step(carry)
            clock.mark()
        clock.wait(-1)
        ms = clock.step_ms()
        means = _means(carry)
        rel = [m - s if i == t_index else (m / s if s else None)
               for i, (m, s) in enumerate(zip(means, start))]
        blocks.append({"first_step": first + 1,
                       "mean_ms": sum(ms) / len(ms),
                       "finite": cell.finite(carry), "fields": rel})
    return blocks


def _first_nonfinite(cell, seed, steps):
    carry = cell.initial(seed)
    for i in range(steps):
        carry = cell.step(carry)
        if not cell.finite(carry):
            return i + 1
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--every", type=int, default=50)
    parser.add_argument("--dt", type=float, nargs="*", default=[])
    parser.add_argument("--episodes", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ncol", type=int, default=None,
                        help="columns instead of the grid's (rehearsal)")
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import harness

    _, workload, config, _ = harness.load_cell(args.workload)
    driver = harness.load_driver(config["kind"])
    device = torch.device("cuda", 0) if args.device == "cuda" else (
        torch.device(args.device))
    card = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else device.type)
    head = {"cell": args.workload, "seed": args.seed, "card": card}

    cell = driver.Cell(config, workload, device, args.ncol)
    blocks = _rollout(cell, args.seed, args.steps, args.every)
    print(json.dumps({**head, "part": "rollout", "dt": cell.dt,
                      "fields": list(driver.FIELDS), "blocks": blocks}),
          flush=True)
    for dt in args.dt:
        other = copy.deepcopy(workload)
        other["step"]["dt"] = dt
        probe = driver.Cell(config, other, device, args.ncol)
        print(json.dumps({**head, "part": "dt", "dt": dt,
                          "steps": args.steps,
                          "first_nonfinite_step": _first_nonfinite(
                              probe, args.seed, args.steps)}), flush=True)
        del probe
    for episode in args.episodes:
        w = harness.drive(cell, cell.step, args.seed, args.seconds, False,
                          time.perf_counter(), episode)
        e2e = harness.window_metrics(cell.points, w.step_ms, w.elapsed)
        print(json.dumps({**head, "part": "episodes", "episode": episode,
                          "steps": w.steps, **e2e}), flush=True)
        del w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
