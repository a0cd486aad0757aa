"""The port runs without JAX: importing it and stepping a column on the CPU
loads no ``jax`` module, every module of the package imports with JAX
blocked, the 2M column step (also column-sharded on a one-rank gloo
group), the 2M + P3 column step, a short parcel run, the liquid-only
example, a short EKI, a trees fit and a TOML override load run with JAX
blocked, and no module of the package imports one."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "cloudmicrophysics_tpu",
                                  "flax", "optax"):
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
import torch.distributed as dist
from cloudmicrophysics_tpu_torch.parallel import (
    column_mesh, is_dtensor, shard_columns)
mesh = column_mesh(device="cpu")
sharded = model(shard_columns(st, mesh))
assert all(is_dtensor(t) for t in sharded)
assert all(torch.equal(a.to_local(), b) for a, b in zip(sharded, model(st)))
dist.destroy_process_group()
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
            "perf", "roofline", "parameters/aerosol",
            "parameters/aerosol_species", "parameters/modal_nucleation",
            "ops/aerosol_activation", "ops/nucleation", "ops/diagnostics",
            "ops/susceptibility", "models/parcel", "models/box",
            "models/p3_sandbox", "models/calibration", "models/aida",
            "models/emulator", "parameters/config", "utils/show",
            "utils/artifacts", "parallel/comms", "parallel/dryrun",
            "examples/__init__", "examples/__main__", "examples/common",
            "examples/column_squall_p3"} <= modules
    from cloudmicrophysics_tpu_torch.examples import NAMES

    assert {f"examples/{n}" for n in NAMES} <= modules
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


_PARCEL_SCRIPT = _BLOCK + """
import torch
from cloudmicrophysics_tpu_torch.models import parcel as PM
from cloudmicrophysics_tpu_torch.parameters import parcel_state_from_numpy
from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Sulfate
ic = parcel_state_from_numpy(dict(
    S_l=1.005, p_air=8e4, T=285.0, q_vap=8e-3, q_liq=0.0, q_ice=0.0,
    N_aer=1e8, N_liq=0.0, N_ice=0.0, ln_inpc=0.0), device="cpu",
    dtype=torch.float64)
params = PM.parcel_params(aerosol_act="AeroAct", aerosol=Sulfate(),
                          aero_sigma_g=2.0, r_nuc=5e-8,
                          condensation_growth="Condensation", const_dt=0.1,
                          w=1.0)
traj = PM.run_parcel(ic, 0.0, 2.0, params)
assert traj.S_l.shape == (21,)
assert all(bool(torch.isfinite(v).all()) for v in traj)
assert float(traj.N_liq[-1]) > 0
mods = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "cloudmicrophysics_tpu"))
print("JAX_MODULES", mods)
"""


def test_parcel_runs_with_jax_blocked():
    proc = _run(_PARCEL_SCRIPT)
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


_EXAMPLE_SCRIPT = _BLOCK + """
from cloudmicrophysics_tpu_torch.examples import parcel_liquid_only
out = parcel_liquid_only.main(["--device", "cpu"])
assert out["steps"] == 80 and out["rogers_max_err"] < 0.1
mods = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "cloudmicrophysics_tpu"))
print("JAX_MODULES", mods)
"""


def test_example_runs_with_jax_blocked():
    proc = _run(_EXAMPLE_SCRIPT)
    assert "max |S - Rogers1975|" in proc.stdout, proc.stdout
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_no_module_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|cloudmicrophysics_tpu|flax|optax)"
        r"\b", re.M)
    offenders = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


_CALIBRATION_SCRIPT = _BLOCK + """
import numpy as np
import torch
from cloudmicrophysics_tpu_torch.models import calibration as CAL
from cloudmicrophysics_tpu_torch.models import emulator as EM
from cloudmicrophysics_tpu_torch import parameters as P
A = torch.as_tensor(np.random.default_rng(0).normal(size=(6, 2)))
y = A @ torch.tensor([2.0, -1.5], dtype=torch.float64)
res = CAL.eki_calibrate(lambda t: t @ A.T, [0.0, 0.0], [2.0, 2.0], y,
                        np.eye(6) * 1e-6, n_ensemble=30, n_iterations=10,
                        device="cpu")
assert np.allclose(res.theta.numpy(), [2.0, -1.5], atol=0.05)
X, yy = EM.generate_training_data(
    P.aerosol.AerosolActivationParameters(), P.AirProperties(),
    P.ThermodynamicsParameters(), n_samples=256, seed=1, device="cpu")
model, params, rmse = EM.train_emulator_trees(X, yy, n_trees=20, depth=4,
                                              device="cpu")
assert params["leaves"].shape == (20, 16) and rmse < 0.2
mp = P.microphysics_1m_params_from_overrides(
    P.calibrated_overrides("CliMA_1M"))
assert mp.terminal_velocity.rain.chiv != P.microphysics_1m_params(
    ).terminal_velocity.rain.chiv
mods = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "cloudmicrophysics_tpu", "flax", "optax"))
print("JAX_MODULES", mods)
"""


def test_calibration_emulator_and_config_run_with_jax_blocked():
    proc = _run(_CALIBRATION_SCRIPT)
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
