"""Parity of the port's utils/special with the JAX package (float64).

Tolerance: the JAX package builds expm1 from tanh and lgamma from a
Lanczos series (absolute error ~1e-13, its utils/special.py:179-188);
the port uses PyTorch's own functions, so they agree to ~1e-12, not
bitwise. The threshold helpers are exact.
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
