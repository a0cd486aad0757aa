"""The port's public point-wise P3 tendencies against the JAX package's, on
the cell ``p3_tend_gl40``'s host state.

``bulk_microphysics_tendencies`` with a P3 ``Microphysics2MParams`` (the
call the cell's host makes, on the CPU the eager code that the CUDA route is
held to bit for bit) against the JAX package's ``bulk_tendencies_2m``, in
float64, on the seeded recipe of ``bench_h100/drivers/p3_tendencies.py`` at
64 x 16: clear columns (ice-free points), mixed-phase points and cold ice
down to 210 K, with the per-point INP log shift drawn from N(0, 1.37^2).
Both sides take log lambda from one shape solve, the port's (the host's
solve as the cell runs it on the CPU), and the same shift. At GL-16 and
GL-40 (ClimaAtmos's order). Tolerance: rtol 1e-9 with an absolute floor of
1e-12 of each rate's largest magnitude, ``test_torch_p3_ladder``'s, since
the two packages run the same float64 arithmetic in other libraries' exp,
log and pow and other summation orders.

The two packages' shape solves are compared beside: they agree to rtol 1e-9
at all but a few ice points (5 of 396 at this seed), where the solve's
fixed 10 Brent iterations end short of the root on one side and not on the
other (an ulp apart in the shape problem picks another step): up to 2.1e-5
apart in log lambda, the unconverged side's residual up to 5e-4 and the
other's 0 to 4e-7. So the solves are held to 1e-9 at 98 % of the ice points
and to 1e-4 at every point, and the rates are compared on one solve.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models.tendencies import bulk_tendencies_2m as JB
from cloudmicrophysics_tpu.ops import p3 as JP3
from cloudmicrophysics_tpu_torch.models import tendencies as TT
from cloudmicrophysics_tpu_torch.ops import p3 as TP3

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import harness  # noqa: E402
from bench_h100.drivers import p3_tendencies as D  # noqa: E402

TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
RTOL, ATOL_REL = 1e-9, 1e-12
SEED = 2**34 + 2026
NCOL, NLEV = 64, 16
NFIELDS = 11


def _state():
    config = dict(harness.load_cell("p3_tend_gl40")[2], nlev=NLEV)
    return D.make_state(config, NCOL, SEED, "cpu", torch.float64)


def _jax(mp, fields, ll, shift):
    """The JAX package's shape solve, and its rates for log lambda ``ll``."""
    def rates(c, ll, shift):
        rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, \
            b_rim = c
        ps = JP3.state_from_prognostic(mp.ice.scheme, q_ice * rho,
                                       n_ice * rho, q_rim * rho, b_rim * rho)
        return JP3.get_distribution_loglambda(ps), JB(
            mp, TPS_J, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice,
            n_ice, q_rim, b_rim, ll, shift)

    return jax.jit(rates)(tuple(jnp.asarray(f.numpy()) for f in fields),
                          jnp.asarray(ll.numpy()), jnp.asarray(shift.numpy()))


def _solve(mp, fields):
    """The port's shape solve on the raw state (the host's, cold)."""
    rho, q_ice, n_ice, q_rim, b_rim = (fields[0], *fields[7:])
    ps = TP3.state_from_prognostic(mp.ice.scheme, q_ice * rho, n_ice * rho,
                                   q_rim * rho, b_rim * rho)
    return TP3.get_distribution_loglambda(ps)


@pytest.mark.parametrize("order", [16, 40])
def test_port_tendencies_match_jax_on_the_cells_recipe(order):
    state = _state()
    fields, shift = state[:NFIELDS], state.inpc_log_shift
    # the recipe's cover: clear and mixed-phase points, cold ice, a shift
    q_lcl, q_ice = state.q_lcl, state.q_ice
    assert bool(((q_lcl == 0) & (q_ice == 0)).any())
    assert bool(((q_lcl > 0) & (q_ice > 0)).any())
    assert bool(((q_ice > 0) & (state.T < 215.0)).any())
    assert float(shift.abs().max()) > 1.0
    mp_j = JP.microphysics_2m_params(with_ice=True, quadrature_order=order)
    mp_t = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(mp_j))
    ll = _solve(mp_t, fields)
    ll_j, ref = _jax(mp_j, fields, ll, shift)
    out = TT.bulk_microphysics_tendencies(mp_t, TPS_T, *fields, ll, shift)

    ll_j, ll_t = np.asarray(ll_j), ll.numpy()
    fin = np.isfinite(ll_j)
    np.testing.assert_array_equal(np.isfinite(ll_t), fin)
    np.testing.assert_allclose(ll_t[fin], ll_j[fin], rtol=1e-4)
    close = np.isclose(ll_t[fin], ll_j[fin], rtol=RTOL, atol=0)
    assert close.mean() >= 0.98, (int((~close).sum()), int(fin.sum()))

    assert type(out).__name__ == "Tendencies2M"
    for name, a, b in zip(ref._fields, out, ref):
        b = np.asarray(b)
        assert a.shape == (NCOL, NLEV) and a.dtype == torch.float64, name
        assert np.isfinite(b).all() and torch.isfinite(a).all(), name
        atol = ATOL_REL * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=f"GL-{order}: {name}")
    # the comparison holds something: ice rates where ice is, and the
    # shift moves the ice number there
    assert float(np.abs(np.asarray(ref.dq_ice_dt)).max()) > 0
    unshifted = TT.bulk_microphysics_tendencies(mp_t, TPS_T, *fields, ll)
    assert not torch.equal(unshifted.dn_ice_dt, out.dn_ice_dt)
