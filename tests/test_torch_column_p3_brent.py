"""Why tests/test_torch_column_p3_wide.py sets cells aside at 300 levels.
The shape solve's Brent runs a fixed number of trips (8 at float32, 10 at
float64, as the reference's ``FixedIterations``); where it has not
converged, the iterate it ends at follows last-bit differences of the
residual, which torch's and XLA's transcendentals give in a few cells of
600. With both packages' Brent run to 40 trips, the same states agree in
every cell at rtol 1e-9, cold and warm-started: the cells set aside are
the fixed trip count's, not a difference of the steps.

Run as a script, it prints the cells each seed sets aside at the default
trip count and at 40 trips::

    JAX_PLATFORMS=cpu python tests/test_torch_column_p3_brent.py
"""

import os
import sys

import numpy as np
import pytest
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import cloudmicrophysics_tpu.ops.p3 as JO  # noqa: E402
import cloudmicrophysics_tpu_torch.ops.p3 as TO  # noqa: E402
from cloudmicrophysics_tpu_torch.models import column as TC  # noqa: E402
from test_torch_column_p3 import (  # noqa: E402
    DT,
    DZ,
    TPS_T,
    _arrays,
    _torch_state,
)
from test_torch_column_p3_scope import (  # noqa: E402
    _solver_cells,
    check_both_starts,
    jax_two_steps,
    params_pair,
)

TRIPS = 40


def _brent_trips(trips):
    """Both packages' fixed-trip Brent, run to ``trips`` trips."""
    jax_brent, torch_brent = JO._brent_fixed, TO._brent_fixed

    def j(f, lo, f_lo, hi, f_hi, n_iters, unroll=None):
        return jax_brent(f, lo, f_lo, hi, f_hi, trips, unroll)

    def t(f, lo, f_lo, hi, f_hi, n_iters):
        return torch_brent(f, lo, f_lo, hi, f_hi, trips)

    return j, t


@pytest.mark.parametrize("seed", [5, 8])
def test_set_aside_cells_agree_at_more_brent_trips(seed, monkeypatch):
    j, t = _brent_trips(TRIPS)
    monkeypatch.setattr(JO, "_brent_fixed", j)
    monkeypatch.setattr(TO, "_brent_fixed", t)
    mp_j, mp_t = params_pair(dict(quadrature_order=4))
    a = _arrays(ncol=2, nlev=300, seed=seed)
    # every cell held: no cell set aside
    check_both_starts(mp_t, a, jax_two_steps(mp_j, a), max_aside=0)


def _set_aside(seed):
    """The cells whose log lambda the two packages put more than rtol
    apart, cold and warm, with the gap in each."""
    mp_j, mp_t = params_pair(dict(quadrature_order=4))
    a = _arrays(ncol=2, nlev=300, seed=seed)
    _, ll_ref, guess, _, ll_ref2 = jax_two_steps(mp_j, a)
    _, ll = TC.step_column_p3(_torch_state(a), mp_t, TPS_T, DT, DZ)
    _, ll2 = TC.step_column_p3(_torch_state(a), mp_t, TPS_T, DT, DZ,
                               torch.tensor(np.asarray(guess)))
    out = {}
    for start, got, ref in (("cold", ll, ll_ref), ("warm", ll2, ll_ref2)):
        got, ref = got.numpy(), np.asarray(ref)
        off, _ = _solver_cells(got, ref)
        out[start] = [(tuple(int(i) for i in c), float(abs(got[tuple(c)]
                                                          - ref[tuple(c)])))
                      for c in np.argwhere(off)]
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    plain = JO._brent_fixed, TO._brent_fixed
    for seed in (5, 6, 7, 8):
        for trips in (None, TRIPS):
            JO._brent_fixed, TO._brent_fixed = (_brent_trips(trips) if trips
                                                else plain)
            cells = _set_aside(seed)
            print(f"seed {seed}, Brent trips "
                  f"{trips or 'default (10 at float64)'}: "
                  + "; ".join(f"{k} {len(v)} cells" + (
                      f", largest log lambda gap {max(g for _, g in v):.3e}"
                      if v else "") for k, v in cells.items()), flush=True)
