"""The states the benchmarks and the roofline step, built from a seed.

* :func:`state_recipe` / :func:`device_state` — the 1M column state of the
  repository's benchmark (``__graft_entry__._build``): rho 1.2 -> 0.4 and
  T 300 -> 220 K over the levels, random contents from ``seed``;
* :func:`state_recipe_2m` / :func:`device_state_2m` — the 2M column state
  of the port's benchmarks: the 1M recipe's rho and T profiles, random
  contents and numbers from ``seed``;
* :data:`UNIFORM_2M` / :func:`uniform_state_2m` — the TPU benchmark's
  uniform 2M warm-rain state (``benchmarks/bench_suite.py:150-153``, the
  roofline's ``2m_column_step`` row);
* :data:`BENCH_P3` / :func:`uniform_state_p3` — the TPU benchmark's 2M + P3
  state (``benchmarks/bench_suite.py:220-223``, the roofline's
  ``p3_column_step`` row); :func:`p3_bench_state` — it with rho and T
  profiles over the levels and a seeded jitter, the port's P3 benchmark.

Arrays are made in numpy float64 and rounded once to float32, so a state
is the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .column import ColumnState, ColumnState2M, ColumnStateP3

__all__ = [
    "BENCH_P3",
    "UNIFORM_2M",
    "device_state",
    "device_state_2m",
    "p3_bench_state",
    "state_recipe",
    "state_recipe_2m",
    "uniform_state_2m",
    "uniform_state_p3",
]

# rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai
UNIFORM_2M = (1.1, 288.0, 6e-3, 1e-3, 9e7, 5e-4, 9e5)
# rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
BENCH_P3 = (1.1, 263.0, 6e-3, 1e-3, 9e7, 5e-4, 9e5, 5e-4, 1e5, 1e-4, 2e-7)


def state_recipe(ncol: int, nlev: int, seed: int = 0):
    """The benchmark's 1M state, field by field in :class:`ColumnState`
    order, as numpy float64 ``(ncol, nlev)`` arrays."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    yield np.linspace(1.2, 0.4, nlev)[None, :] * ones
    yield np.linspace(300.0, 220.0, nlev)[None, :] * ones
    for scale in (1e-2, 1e-3, 5e-4, 5e-4, 5e-4):
        yield scale * rng.random(shape)


def state_recipe_2m(ncol: int, nlev: int, seed: int = 0):
    """The 2M state, field by field in :class:`ColumnState2M` order, as
    numpy float64 ``(ncol, nlev)`` arrays."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    yield np.linspace(1.2, 0.4, nlev)[None, :] * ones
    yield np.linspace(300.0, 220.0, nlev)[None, :] * ones
    for scale in (1e-2, 1e-3, 1e8, 5e-4, 1e6):
        yield scale * rng.random(shape)


def _tensors(arrays, device):
    return (torch.from_numpy(np.asarray(a, np.float64)).to(torch.float32)
            .to(device) for a in arrays)


def device_state(ncol: int, nlev: int, device, seed: int = 0) -> ColumnState:
    """:func:`state_recipe` as a float32 :class:`ColumnState` on
    ``device``."""
    return ColumnState(*_tensors(state_recipe(ncol, nlev, seed), device))


def device_state_2m(ncol: int, nlev: int, device,
                    seed: int = 0) -> ColumnState2M:
    """:func:`state_recipe_2m` as a float32 :class:`ColumnState2M` on
    ``device``."""
    return ColumnState2M(*_tensors(state_recipe_2m(ncol, nlev, seed),
                                   device))


def uniform_state_2m(ncol: int, nlev: int, device) -> ColumnState2M:
    """:data:`UNIFORM_2M` in every cell, float32, on ``device``."""
    return ColumnState2M(*_tensors(
        (np.full((ncol, nlev), v) for v in UNIFORM_2M), device))


def uniform_state_p3(ncol: int, nlev: int, device) -> ColumnStateP3:
    """:data:`BENCH_P3` in every cell, float32, on ``device``."""
    return ColumnStateP3(*_tensors(
        (np.full((ncol, nlev), v) for v in BENCH_P3), device))


def p3_bench_state(ncol: int, nlev: int, device,
                   seed: int = 0) -> ColumnStateP3:
    """:data:`BENCH_P3` with rho 1.2 -> 0.5 and T 270 -> 250 K over the
    levels and a seeded +-50 % jitter of every content and number, float32,
    on ``device``."""
    rng = np.random.default_rng(seed)
    ones = np.ones((ncol, 1))
    arrays = [np.linspace(1.2, 0.5, nlev)[None] * ones,
              np.linspace(270.0, 250.0, nlev)[None] * ones]
    arrays += [v * (1 + 0.5 * (2 * rng.random((ncol, nlev)) - 1))
               for v in BENCH_P3[2:]]
    return ColumnStateP3(*_tensors(arrays, device))
