"""Run one cell of the benchmark once and print its result line.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, this folder and
the program (``cloudmicrophysics_tpu_torch``). It makes the cell's state on
the card from the seed, builds and warms up the cell's step, steps it in a
closed loop for ``--seconds`` seconds, checks what it produced against the
plain reference and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window. Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the toolchain, at fixed paths inside the checkout, so that the
# first run of a cell in a checkout builds and later ones reuse
CACHE = ROOT / "bench_h100" / ".cache"


def _environment() -> None:
    for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    import torch

    from bench_h100 import harness

    torch.set_num_threads(2)
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except harness.BenchError as err:
        print(f"bench_h100: {err}", file=sys.stderr)
        return 2
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
