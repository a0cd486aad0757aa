"""The port runs without JAX: importing it and stepping a column on the CPU
loads no ``jax`` module, and no module of the package imports one."""

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
                     terminal_velocity_params(), 1.0, 100.0)
out = model(pack_state(st))
assert out.shape == (7, n, k) and bool(torch.isfinite(out).all())
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "cloudmicrophysics_tpu")
             or m.startswith(("jax.", "jaxlib.", "cloudmicrophysics_tpu.")))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_import_and_cpu_step_load_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


def test_no_module_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|cloudmicrophysics_tpu)\b", re.M)
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
