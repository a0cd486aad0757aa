"""The port's quadrature rules (utils/quadrature.py) against the JAX package.

The node/weight tables are host-side float64 numpy in both packages and
must agree exactly; mapped nodes and integrals are compared at float64 with
rtol 1e-12 (one affine map and one sum, a few ULP apart at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu.utils import quadrature as JQ
from cloudmicrophysics_tpu_torch.utils import quadrature as TQ

RTOL = 1e-12


@pytest.mark.parametrize("order", [4, 8, 16, 32, 40, 64, 5, 10, 25, 100])
def test_build_quadrature_tables_match(order):
    rule_t, rule_j = TQ.build_quadrature(order), JQ.build_quadrature(order)
    assert type(rule_t).__name__ == type(rule_j).__name__
    assert rule_t.n == rule_j.n == order
    for a, b in zip(rule_t.nodes_weights(), rule_j.nodes_weights()):
        np.testing.assert_array_equal(a, b)
    tab_t, tab_j = TQ.tabulate(rule_t), JQ.tabulate(rule_j)
    assert tab_t.n == tab_j.n
    for a, b in zip(tab_t.nodes_weights(), tab_j.nodes_weights()):
        assert a.shape == (order, 1, 1)
        np.testing.assert_array_equal(a, np.asarray(b))


def test_default_quadrature():
    assert TQ.default_quadrature() == TQ.ChebyshevGauss(100)
    assert type(JQ.default_quadrature()).__name__ == "ChebyshevGauss"


def _bounds(seed=0, shape=(5, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1e-5, 1e-3, shape)
    b = a + rng.uniform(0, 2e-3, shape)
    b[0, 0] = a[0, 0]            # collapsed window
    b[1, 1] = a[1, 1] * 0.5      # inverted window
    return a, b


@pytest.mark.parametrize("rule", [TQ.GaussLegendre(8), TQ.ChebyshevGauss(7),
                                  TQ.tabulate(TQ.GaussLegendre(4))])
def test_nodes_match(rule):
    a, b = _bounds()
    jrule = (JQ.tabulate(JQ.GaussLegendre(4)) if isinstance(rule, TQ.Tabulated)
             else getattr(JQ, type(rule).__name__)(rule.n))
    x_t, w_t = TQ.nodes(rule, torch.tensor(a), torch.tensor(b))
    x_j, w_j = JQ.nodes(jrule, jnp.asarray(a), jnp.asarray(b))
    assert x_t.shape == (rule.n,) + a.shape
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=0)
    assert (w_t[:, 0, 0] == 0).all() and (w_t[:, 1, 1] == 0).all()


def test_segment_nodes_match():
    rng = np.random.default_rng(1)
    edges = np.sort(rng.uniform(1e-6, 1e-2, (5, 4, 6)), axis=0)
    edges[2, :, 0] = edges[1, :, 0]        # a collapsed segment
    bt = tuple(torch.tensor(e) for e in edges)
    bj = tuple(jnp.asarray(e) for e in edges)
    rule_t = TQ.tabulate(TQ.GaussLegendre(8))
    rule_j = JQ.tabulate(JQ.GaussLegendre(8))
    x_t, w_t = TQ.segment_nodes(rule_t, bt)
    x_j, w_j = JQ.segment_nodes(rule_j, bj)
    assert x_t.shape == (4 * 8, 4, 6)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL)


@pytest.mark.parametrize("order", [4, 16, 25])
def test_integrate_and_segments_match(order):
    a, b = _bounds(2)
    rule_t, rule_j = TQ.build_quadrature(order), JQ.build_quadrature(order)

    def f_t(x):
        return torch.exp(-1e3 * x) * x**2

    def f_j(x):
        return jnp.exp(-1e3 * x) * x**2

    got = TQ.integrate(f_t, torch.tensor(a), torch.tensor(b), rule_t)
    ref = JQ.integrate(f_j, jnp.asarray(a), jnp.asarray(b), rule_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    assert got[0, 0] == 0 and got[1, 1] == 0
    mid = (a + b) / 2
    got = TQ.integrate_segments(
        f_t, tuple(torch.tensor(v) for v in (a, mid, b)), rule_t)
    ref = JQ.integrate_segments(
        f_j, tuple(jnp.asarray(v) for v in (a, mid, b)), rule_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_gauss_legendre_integrates_polynomials_exactly():
    # degree 2n - 1 exactly on [0, 2]: int x^7 = 2^8 / 8
    got = TQ.integrate(lambda x: x**7, torch.tensor(0.0, dtype=torch.float64),
                       torch.tensor(2.0, dtype=torch.float64),
                       TQ.GaussLegendre(4))
    assert abs(float(got) - 32.0) < 1e-12
