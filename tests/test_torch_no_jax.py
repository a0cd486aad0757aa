"""The port runs without JAX: importing it and stepping a column on the CPU
loads no ``jax`` module, every module of the package imports with JAX
blocked, the 2M + P3 column step runs with JAX blocked, and no module of
the package imports one."""

import os
import re
import subprocess
import sys
from pathlib import Path

import cloudmicrophysics_tpu_torch

PKG = Path(cloudmicrophysics_tpu_torch.__file__).resolve().parent

_SCRIPT = """
import sys
import cloudmicrophysics_tpu_torch as cmt
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters, microphysics_1m_params, terminal_velocity_params)
from cloudmicrophysics_tpu_torch.kernels import pack_state
from cloudmicrophysics_tpu_torch.models.column import ColumnState, Column1MStep
import torch
n, k = 8, 6
st = ColumnState(
    rho=torch.linspace(1.2, 0.5, k).expand(n, k).contiguous(),
    T=torch.linspace(295.0, 240.0, k).expand(n, k).contiguous(),
    q_tot=torch.full((n, k), 1e-2), q_lcl=torch.full((n, k), 5e-4),
    q_icl=torch.full((n, k), 2e-4), q_rai=torch.full((n, k), 3e-4),
    q_sno=torch.full((n, k), 2e-4))
model = Column1MStep(microphysics_1m_params(), ThermodynamicsParameters(),
                     terminal_velocity_params(), 1.0, 100.0, device="cpu")
out = model(pack_state(st))
assert out.shape == (7, n, k) and bool(torch.isfinite(out).all())
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "cloudmicrophysics_tpu")
             or m.startswith(("jax.", "jaxlib.", "cloudmicrophysics_tpu.")))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_import_and_cpu_step_load_no_jax():
    proc = _run(_SCRIPT)
    assert "JAX_MODULES []" in proc.stdout


_BLOCK = """
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cloudmicrophysics_tpu"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, _Block())
"""

_BLOCKED_SCRIPT = _BLOCK + """
import importlib
import pkgutil
import cloudmicrophysics_tpu_torch as cmt
names = [m.name for m in pkgutil.walk_packages(cmt.__path__,
                                                "cloudmicrophysics_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from cloudmicrophysics_tpu_torch.kernels import pack_state_2m
from cloudmicrophysics_tpu_torch.models.column import (
    Column2MStep, ColumnState2M)
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters, microphysics_2m_params)
n, k = 8, 6
st = ColumnState2M(
    rho=torch.linspace(1.2, 0.5, k).expand(n, k).contiguous(),
    T=torch.linspace(295.0, 260.0, k).expand(n, k).contiguous(),
    q_tot=torch.full((n, k), 1e-2), q_lcl=torch.full((n, k), 5e-4),
    n_lcl=torch.full((n, k), 5e7), q_rai=torch.full((n, k), 3e-4),
    n_rai=torch.full((n, k), 5e5))
model = Column2MStep(microphysics_2m_params(rain_velocity="chen2022"),
                     ThermodynamicsParameters(), 1.0, 100.0, device="cpu")
out = model(pack_state_2m(st))
assert out.shape == (7, n, k) and bool(torch.isfinite(out).all())
print("IMPORTED", len(names))
"""


def test_every_module_imports_with_jax_blocked():
    proc = _run(_BLOCKED_SCRIPT)
    # walk_packages lists every module and every subpackage
    modules = {p.relative_to(PKG).with_suffix("").as_posix()
               for p in PKG.rglob("*.py") if p.parent != PKG
               or p.name != "__init__.py"}
    assert {"utils/distributions", "parameters/m2", "ops/m2",
            "kernels/column2m", "utils/quadrature", "parameters/p3",
            "parameters/ice_nucleation", "ops/p3", "ops/p3_processes",
            "ops/ice_nucleation", "models/p3_tendencies",
            "kernels/column_p3", "kernels/roof", "models/bench_states",
            "perf", "roofline"} <= modules
    assert f"IMPORTED {len(modules)}" in proc.stdout, proc.stdout


_P3_SCRIPT = _BLOCK + """
import torch
from cloudmicrophysics_tpu_torch.models.column import (
    ColumnP3Step, ColumnStateP3)
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters, microphysics_2m_params)
n, k = 4, 5
full = lambda v: torch.full((n, k), v, dtype=torch.float64)
st = ColumnStateP3(
    rho=torch.linspace(1.2, 0.6, k, dtype=torch.float64).expand(n, k),
    T=torch.linspace(268.0, 250.0, k, dtype=torch.float64).expand(n, k),
    q_tot=full(8e-3), q_lcl=full(5e-4), n_lcl=full(5e7), q_rai=full(1e-4),
    n_rai=full(1e5), q_ice=full(5e-4), n_ice=full(1e5), q_rim=full(1e-4),
    b_rim=full(2e-7))
model = ColumnP3Step(microphysics_2m_params(with_ice=True, quadrature_order=4),
                     ThermodynamicsParameters(), 1.0, 100.0, device="cpu")
out, loglam = model(st)
out, loglam = model(out, loglam)
assert all(bool(torch.isfinite(t).all()) for t in out)
assert bool(torch.isfinite(loglam).all()) and bool((out.q_rim <= out.q_ice).all())
mods = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "cloudmicrophysics_tpu"))
print("JAX_MODULES", mods)
"""


def test_p3_step_runs_with_jax_blocked():
    proc = _run(_P3_SCRIPT)
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_no_module_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|cloudmicrophysics_tpu)\b", re.M)
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
