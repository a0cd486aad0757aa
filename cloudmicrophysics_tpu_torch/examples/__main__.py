"""Run every example in order, each printing its script's lines, then
each one's wall seconds, steps and steps/s (parcel and box Euler steps;
column steps for the squall), and one JSON line of the same.

Run: ``python -m cloudmicrophysics_tpu_torch.examples [--device cpu]``
"""

import importlib
import json
import sys

import torch

from . import NAMES
from .common import parse_args, timed


def main(argv=None):
    cli = parse_args(__doc__, argv)
    rows = []
    for name in NAMES:
        mod = importlib.import_module(f"{__package__}.{name}")
        seconds, out = timed(lambda: mod.main(["--device", cli.device]),
                             cli.device)
        rows.append({"name": name, "steps": out["steps"],
                     "seconds": seconds,
                     "steps_per_s": out["steps"] / seconds})
        sys.stdout.flush()
    kind = (torch.cuda.get_device_name(torch.device(cli.device))
            if torch.device(cli.device).type == "cuda" else "cpu")
    print(f"== examples on {cli.device} ({kind})")
    for r in rows:
        print(f"  {r['name']:30s} {r['seconds']:10.3f} s {r['steps']:8d} "
              f"steps {r['steps_per_s']:10.1f} steps/s")
    print(json.dumps({"examples": rows, "device": kind}))
    return rows


if __name__ == "__main__":
    main()
