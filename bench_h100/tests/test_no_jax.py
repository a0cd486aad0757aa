"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Each import runs in a fresh
process; top-level module names are compared whole, because the program's
name begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudmicrophysics_tpu")


def _top_level_after(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_readers_and_reference_load_no_jax():
    metrics = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    code = ("from bench_h100 import harness, check, inputs, roofline, "
            "reference; import bench_h100.run; "
            "from bench_h100.drivers import column_1m, column_p3; "
            + "; ".join(f"harness.load_metric({m!r})" for m in metrics)
            # a whole traced run of each kind, on the CPU at a few columns
            + "; harness.SAMPLE_STEPS = 1"
            + "".join(f"; harness.run({c!r}, 5, 0.05, True, 0.0, "
                      f"device='cpu', ncol=1)" for c in ("1m_inst",
                                                         "p3_gl16")))
    loaded = _top_level_after(code)
    assert "cloudmicrophysics_tpu_torch" in loaded   # the program itself
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after("import bench_h100.reference as R; "
                              "R.params_1m(); R.params_p3(16)")
    assert not loaded & {*FORBIDDEN, "cloudmicrophysics_tpu_torch"}


def test_no_file_names_the_jax_benchmark():
    # the names are built here so that this file does not hold them
    names = ("bench" + "marks/", "bench" + ".py")
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".md"):
            text = path.read_text()
            for name in names:
                assert name not in text, f"{path} names {name}"
