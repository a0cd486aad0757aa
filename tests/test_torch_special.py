"""Parity of the port's utils/special with the JAX package.

Tolerances:

* float64 elementwise functions: rtol 1e-12, atol 1e-12. The JAX package
  builds expm1 from tanh and lgamma from a Lanczos series (absolute error
  ~1e-13, its utils/special.py:179-188); the port uses PyTorch's own
  functions, so they agree to ~1e-12, not bitwise. The threshold helpers
  are exact.
* gamma_inc / gamma_inc_inv, float64: rtol 1e-9 with an absolute floor of
  1e-12 (both run the same fixed-trip series, continued fraction and
  Halley steps; torch and XLA:CPU exp/log differ by a few ULP).
* gamma_inc / gamma_inc_inv, float32: rtol 2e-5, atol 2e-6 (the same
  ULP-level differences, carried through 20 series/Lentz terms and 15
  Halley steps in float32).
* the round trip inv(P(a, x)) = x: rtol 1e-9 at float64.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu.utils import special as JS
from cloudmicrophysics_tpu_torch.utils import special as TS

RTOL, ATOL = 1e-12, 1e-12


@pytest.mark.parametrize("name", ["machine_eps", "floatmin", "eps_numerics",
                                  "eps_numerics_2M_M", "eps_numerics_2M_N",
                                  "eps_numerics_P3_B"])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_thresholds_match(name, dt):
    assert getattr(TS, name)(getattr(torch, dt)) == \
        getattr(JS, name)(getattr(jnp, dt))


def test_float_dtype():
    f32 = torch.zeros(2, dtype=torch.float32)
    f64 = torch.zeros(2, dtype=torch.float64)
    assert TS.float_dtype(f32, 1.0) == torch.float32
    assert TS.float_dtype(f32, f64) == torch.float64
    assert TS.float_dtype(torch.zeros(2, dtype=torch.int32)) == torch.float64
    assert TS.float_dtype(1.0, 2) == torch.float64


def test_fac():
    assert [TS.fac(n) for n in range(6)] == [JS.fac(n) for n in range(6)]
    with pytest.raises(ValueError):
        TS.fac(21)


X = np.concatenate([np.linspace(-3.0, 3.0, 61), [1e-9, -1e-9, 0.0, 0.999]])
POS = np.concatenate([np.linspace(0.05, 30.0, 80), [1.0, 2.0, 0.5]])


@pytest.mark.parametrize("name,x", [
    ("expm1", X), ("cbrt", X), ("atanh", np.linspace(-0.99, 0.99, 41)),
    ("clamp_to_nonneg", X), ("lgamma", POS), ("gamma", POS[POS < 20]),
])
def test_elementwise_match(name, x):
    ref = np.asarray(getattr(JS, name)(jnp.asarray(x)))
    out = getattr(TS, name)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("a", [0.5, 1.0, 3.5, 7.25])
def test_lgamma_gamma_of_python_floats_stay_host_floats(a):
    assert TS.lgamma(a) == math.lgamma(a)
    assert isinstance(TS.gamma(a), float)
    assert math.isclose(TS.gamma(a), float(JS.gamma(a)), rel_tol=1e-14)


# (a, x) pairs on both sides of x = a + 1 (series vs continued fraction),
# the edge cases x = 0, x < 0, x = +inf and NaN in either argument
A_GRID = np.array([0.3, 0.5, 1.0, 2.5, 4.0, 10.0, 20.0, 0.7, 3.0, 5.0, 5.0,
                   5.0, np.nan, 2.0, 1.5])
X_GRID = np.array([0.1, 3.0, 1.0, 0.5, 10.0, 9.0, 25.0, 0.0, np.inf, np.nan,
                   4.0, 60.0, 1.0, -1.0, 1e-8])
INC_TOL = {"float64": (1e-9, 1e-12), "float32": (2e-5, 2e-6)}


def _grid(dt):
    a, x = np.meshgrid(np.concatenate([A_GRID, [0.05, 40.0]]),
                       np.concatenate([X_GRID, [0.02, 45.0]]))
    return a.ravel().astype(dt), x.ravel().astype(dt)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_gamma_inc_matches_jax(dt):
    a, x = _grid(dt)
    ref = JS.gamma_inc(jnp.asarray(a), jnp.asarray(x))
    out = TS.gamma_inc(torch.as_tensor(a), torch.as_tensor(x))
    rtol, atol = INC_TOL[dt]
    for o, r, name in zip(out, ref, "PQ"):
        assert o.dtype == getattr(torch, dt)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert bool(torch.isnan(out[0][np.isnan(a) | np.isnan(x)]).all())
    np.testing.assert_allclose(
        TS.gamma_inc_lower(torch.as_tensor(a), torch.as_tensor(x)).numpy(),
        out[0].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(
        TS.gamma_inc_upper(torch.as_tensor(a), torch.as_tensor(x)).numpy(),
        out[1].numpy(), rtol=0, atol=0)


P_GRID = np.array([1e-6, 0.3, 0.5, 0.7, 0.999999, 0.0, 1.0, 0.2, 0.6, 0.9,
                   1e-5, 0.5, 0.5, 0.02, 0.98])


@pytest.mark.parametrize("n_iters", [4, 15])
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_gamma_inc_inv_matches_jax(dt, n_iters):
    a = A_GRID.astype(dt)
    p = P_GRID.astype(dt)
    q = (1 - P_GRID).astype(dt)
    ref = JS.gamma_inc_inv(jnp.asarray(a), jnp.asarray(p), jnp.asarray(q),
                           n_iters=n_iters)
    out = TS.gamma_inc_inv(torch.as_tensor(a), torch.as_tensor(p),
                           torch.as_tensor(q), n_iters=n_iters)
    rtol, atol = INC_TOL[dt]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol * 1e-6)
    assert out[5] == 0 and out[6] == np.inf and np.isnan(out[12])


def test_gamma_inc_inv_round_trip():
    a = np.repeat([0.3, 1.0, 2.0, 7.5, 20.0], 6)
    x = np.tile([1e-3, 0.2, 1.0, 3.0, 12.0, 30.0], 5)
    p, q = TS.gamma_inc(torch.as_tensor(a), torch.as_tensor(x))
    keep = (p > 1e-12) & (q > 1e-12)
    back = TS.gamma_inc_inv(torch.as_tensor(a), p, q)
    np.testing.assert_allclose(back[keep].numpy(), x[keep.numpy()],
                               rtol=1e-9)


def test_gamma_inc_takes_python_floats_and_broadcasts():
    x = torch.linspace(0.1, 5.0, 7, dtype=torch.float32)
    p, q = TS.gamma_inc(2.5, x)
    assert p.dtype == torch.float32 and p.shape == (7,)
    ref = JS.gamma_inc(2.5, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(p.numpy(), np.asarray(ref[0]), rtol=2e-5,
                               atol=2e-6)


def test_lgamma_pos_matches_jax():
    z = np.concatenate([np.linspace(0.01, 40.0, 60), [0.0, -1.0]])
    ref = JS._lgamma_pos(jnp.asarray(z))
    out = TS._lgamma_pos(torch.as_tensor(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-13)
