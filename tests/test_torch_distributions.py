"""Float64 parity of the port's utils/distributions with the JAX package.

Tolerance: rtol 1e-9 with an absolute floor of 1e-12 of the largest
reference value. The quantiles go through gamma_inc_inv's fixed Halley
steps and the CDFs through gamma_inc's fixed series/continued fraction, in
both packages; torch's and XLA:CPU's exp/log/pow differ by a few ULP.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu.utils import distributions as JD
from cloudmicrophysics_tpu_torch.utils import distributions as TD

RTOL, ATOL_REL = 1e-9, 1e-12

RNG = np.random.default_rng(17)
B = RNG.uniform(0.5, 5e3, 24)
Y = np.concatenate([RNG.uniform(0.01, 0.99, 20), [1e-6, 1e-3, 0.5, 0.999]])
X = np.concatenate([RNG.uniform(0.0, 3e-3, 20), [0.0, -1e-4, 1e-9, 5e-3]])
D_MEAN = RNG.uniform(1e-4, 3e-3, 24)
N = RNG.uniform(1e5, 1e8, 24)


def _close(out, ref):
    ref = np.asarray(ref)
    atol = ATOL_REL * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("nu,mu,n_iters", [(1.0, 1.0, None), (5.0, 1.0, 4),
                                           (-2 / 3, 1 / 3, None)])
def test_generalized_gamma_quantile(nu, mu, n_iters):
    ref = JD.generalized_gamma_quantile(nu, mu, jnp.asarray(B), jnp.asarray(Y),
                                        n_iters=n_iters)
    out = TD.generalized_gamma_quantile(nu, mu, torch.as_tensor(B),
                                        torch.as_tensor(Y), n_iters=n_iters)
    _close(out, ref)


@pytest.mark.parametrize("n_iters", [None, 4])
def test_generalized_gamma_quantile_unit_mu(n_iters):
    ref = JD.generalized_gamma_quantile_unit_mu(2.0, jnp.asarray(B),
                                                jnp.asarray(Y), n_iters)
    out = TD.generalized_gamma_quantile_unit_mu(2.0, torch.as_tensor(B),
                                                torch.as_tensor(Y), n_iters)
    _close(out, ref)


@pytest.mark.parametrize("nu,mu", [(1.0, 1.0), (5.0, 3.0)])
def test_generalized_gamma_cdf(nu, mu):
    ref = JD.generalized_gamma_cdf(nu, mu, jnp.asarray(B), jnp.asarray(X))
    out = TD.generalized_gamma_cdf(nu, mu, torch.as_tensor(B),
                                   torch.as_tensor(X))
    _close(out, ref)


@pytest.mark.parametrize("n", [0.0, 2 / 3, 5 / 3, 3.0])
def test_generalized_gamma_moment(n):
    ref = JD.generalized_gamma_moment(1.0, 1.0, jnp.asarray(B), jnp.asarray(N),
                                      n)
    out = TD.generalized_gamma_moment(1.0, 1.0, torch.as_tensor(B),
                                      torch.as_tensor(N), n)
    _close(out, ref)


def test_exponential_cdf_and_quantile():
    _close(TD.exponential_cdf(torch.as_tensor(D_MEAN), torch.as_tensor(X)),
           JD.exponential_cdf(jnp.asarray(D_MEAN), jnp.asarray(X)))
    _close(TD.exponential_quantile(torch.as_tensor(D_MEAN),
                                   torch.as_tensor(Y)),
           JD.exponential_quantile(jnp.asarray(D_MEAN), jnp.asarray(Y)))
    # a Python-float quantile level, as size_distribution_bounds_rain uses
    _close(TD.exponential_quantile(torch.as_tensor(D_MEAN), 1e-7),
           JD.exponential_quantile(jnp.asarray(D_MEAN), 1e-7))


@pytest.mark.parametrize("n", [0, 1, 3, 6])
def test_exponential_moment(n):
    _close(TD.exponential_moment(torch.as_tensor(D_MEAN), torch.as_tensor(N),
                                 n),
           JD.exponential_moment(jnp.asarray(D_MEAN), jnp.asarray(N), n))


def test_log1mexp():
    x = np.concatenate([-np.logspace(-12, 2, 30), [-1e-300, 0.0]])
    ref = np.asarray(JD.log1mexp(jnp.asarray(x)))
    out = TD.log1mexp(torch.as_tensor(x))
    assert np.isneginf(ref[-1]) and np.isneginf(out[-1].item())
    _close(out[:-1], ref[:-1])
    # the CDF of an exponential PSD is exactly 0 at D = 0
    assert TD.exponential_cdf(torch.tensor([1e-3]), torch.tensor([0.0])) == 0
