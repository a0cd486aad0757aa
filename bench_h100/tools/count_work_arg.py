"""Count once the work per grid point of an activation cell's step, on the
frozen plain reference.

    python3 bench_h100/tools/count_work_arg.py [--ncol 64] [cell ...]

For each cell (of kind ``activation``; ``arg_mam4`` when none is named) it
makes the cell's state at ``--ncol`` columns on the CPU and runs one frozen
reference step (``reference/activation.py:step``: ARG2000's number and mass
and the host update) under a dispatch mode that sees every ATen operation.
Each operation whose output has one value a grid point adds, per point, its
float32 operations and special-function (MUFU) operations from
:data:`COST`: the least a float32 kernel issues for it on the H100 (an add,
multiply or compare one operation; a division a reciprocal and a multiply;
``exp``, ``log`` and a general power their ``ex2``/``lg2`` with the scaling
multiplies; ``erf``/``erfc`` the polynomial and exponential of CUDA's
``erff``/``erfcf``). Operations on single values (the constants filled in
on the device) are per call, not per point, and are not counted; nor is
a recomputation, an operation on the same values as an earlier one of the
same name (the step as it runs computes S_max and the critical
supersaturations once for the number and again for the mass; a kernel
needs them once). So the counts are the step's least work, which a fused
kernel is read against too. They depend on neither the data nor the
device. It prints one JSON line
per cell with the counts per point, the bytes per point (each input field
read once and each answer written once, at the configuration's dtype) and
the operations it counted and those it set aside as recomputed; the
numbers go into ``workloads/<cell>.json`` under ``work`` by hand and are
never counted again.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (float32 operations, MUFU operations) per output value of each ATen
# operation the step runs; pow by its exponent below
COST = {
    "add": (1, 0), "sub": (1, 0), "rsub": (1, 0), "mul": (1, 0),
    "div": (1, 1), "reciprocal": (0, 1), "sqrt": (0, 1),
    "exp": (1, 1), "log": (1, 1), "erf": (18, 1), "erfc": (20, 2),
    "clamp": (1, 0), "maximum": (1, 0), "lt": (1, 0), "gt": (1, 0),
    "where": (0, 0), "zeros_like": (0, 0),
}


def pow_cost(exponent) -> tuple:
    """A power by a constant: repeated multiplies for 2 and 3, a square
    root for 1/2, else ``ex2(y * lg2(x))``; by a tensor, the latter."""
    if isinstance(exponent, (int, float)):
        if exponent == 2:
            return (1, 0)
        if exponent == 3:
            return (2, 0)
        if exponent == 0.5:
            return (0, 1)
    return (1, 2)


def _key(value):
    """A value as a hashable key: a tensor by its dtype, shape and bytes."""
    import torch

    if isinstance(value, torch.Tensor):
        return (str(value.dtype), tuple(value.shape),
                value.detach().contiguous().cpu().numpy().tobytes())
    if isinstance(value, (tuple, list)):
        return tuple(_key(v) for v in value)
    return repr(value)


def count(step, points: int) -> dict:
    """Run ``step()`` and count its per-point work: ``{"flops", "mufu",
    "ops", "recomputed"}``, ``ops`` the per-point operations counted by
    name, ``recomputed`` those set aside."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    seen, again = collections.Counter(), collections.Counter()
    done = set()
    totals = [0.0, 0.0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            first = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(first, torch.Tensor) and first.numel() == points:
                name = func.overloadpacket.__name__.rstrip("_")
                key = (name, _key(args), _key(kwargs or {}))
                if key in done:
                    again[name] += 1
                    return out
                done.add(key)
                if name == "pow":
                    cost = pow_cost(args[1])
                elif name in COST:
                    cost = COST[name]
                else:
                    raise KeyError(f"no cost for {func}")
                seen[name] += 1
                totals[0] += cost[0]
                totals[1] += cost[1]
            return out

    with Counter():
        step()
    return {"flops": totals[0], "mufu": totals[1], "ops": dict(seen),
            "recomputed": dict(again)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cells", nargs="*", default=["arg_mam4"])
    parser.add_argument("--ncol", type=int, default=64)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)

    import torch

    from bench_h100 import check, harness
    from bench_h100.drivers import activation as D
    from bench_h100.reference import activation as R

    for name in args.cells:
        _, workload, config, _ = harness.load_cell(name)
        if config["kind"] != "activation":
            raise SystemExit(f"{name} is of kind {config['kind']}, not "
                             f"activation")
        dtype = check.DTYPES[config["reference_dtype"]]
        layout = R.Layout(config)
        state = D.make_state(config, args.ncol, args.seed, "cpu", dtype)
        points = args.ncol * int(config["nlev"])
        work = count(lambda: R.step(layout, state, *R.params()), points)
        size = torch.finfo(dtype).bits // 8
        bytes_per_point = size * (len(layout.inputs) + len(layout.answers))
        print(json.dumps({"cell": name, "work": {"arg": {
            "bytes_per_point": bytes_per_point,
            "flops_per_point": work["flops"],
            "mufu_per_point": work["mufu"]}},
            "ops_per_point": work["ops"],
            "recomputed_per_point": work["recomputed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
