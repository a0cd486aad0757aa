"""The port's precipitation susceptibility and the derivative rules of
``gamma_inc`` / ``gamma_inc_inv`` against the JAX package at float64.

* Susceptibility (``torch.autograd.grad`` of the summed log-rate) against
  ``jax.grad`` of the scalar log-rate, point by point: rtol 1e-9.
* The ``torch.autograd.Function`` rules against the JAX ``custom_jvp``
  rules: the derivative in ``x`` (``p`` for the inverse) at rtol 1e-10,
  the derivative in ``a`` NaN everywhere, the inverse's derivative in
  ``q`` zero (the JAX rule drops that tangent), ``gradcheck`` of the
  closed-form derivative against finite differences, the rule reached
  through ``torch.func.grad``, and the forward values equal bit for bit
  whether or not an argument requires grad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.ops import susceptibility as JS
from cloudmicrophysics_tpu.utils import special as JSP
from cloudmicrophysics_tpu_torch.ops import susceptibility as TS
from cloudmicrophysics_tpu_torch.utils import special as TSP

SB_J = JP.microphysics_2m_params().warm_rain.seifert_beheng
SB_T = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(
    JP.microphysics_2m_params())).warm_rain.seifert_beheng

POINTS = np.array([
    # q_lcl, q_rai, rho, N_lcl
    [0.5e-3, 1e-5, 1.0, 1e8],
    [1e-3, 2e-4, 1.1, 5e7],
    [2e-4, 1e-6, 0.8, 3e8],
    [3e-3, 1e-3, 1.2, 1e8],
    [8e-4, 5e-5, 0.6, 2e7],
])


@pytest.mark.parametrize("process", ["autoconversion", "accretion"])
def test_susceptibility_matches_jax_grad(process):
    fn_t = getattr(TS, f"precipitation_susceptibility_{process}")
    fn_j = getattr(JS, f"precipitation_susceptibility_{process}")
    got = fn_t(SB_T, *(torch.tensor(POINTS[:, i]) for i in range(4)))
    for k, point in enumerate(POINTS):
        want = fn_j(SB_J, *(jnp.float64(v) for v in point))
        for name in want._fields:
            g = getattr(got, name)
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g[k].item(), float(getattr(
                want, name)), rtol=1e-9, atol=1e-300,
                err_msg=f"{name} at {point}")


def test_susceptibility_casts_float32_inputs_to_float64():
    r = TS.precipitation_susceptibility_accretion(
        SB_T, *(torch.tensor(POINTS[:, i], dtype=torch.float32)
                for i in range(4)))
    assert r.d_ln_pp_d_ln_q_lcl.dtype == torch.float64


A = np.array([0.3, 0.7, 1.0, 2.5, 4.0, 9.0, 20.0])
X = np.array([0.05, 0.4, 1.0, 2.5, 6.0, 15.0, 30.0])
PV = np.array([1e-6, 0.01, 0.2, 0.5, 0.7, 0.95, 1 - 1e-6])


def _grid(u, v):
    uu, vv = np.meshgrid(u, v)
    return uu.ravel(), vv.ravel()


def test_gamma_inc_x_derivative_matches_jax():
    a, x = _grid(A, X)
    xt = torch.tensor(x, requires_grad=True)
    P, Q = TSP.gamma_inc(torch.tensor(a), xt)
    gP, = torch.autograd.grad(P.sum(), xt)
    xt2 = torch.tensor(x, requires_grad=True)
    gQ, = torch.autograd.grad(TSP.gamma_inc(torch.tensor(a), xt2)[1].sum(),
                              xt2)
    aj, xj = jnp.asarray(a), jnp.asarray(x)
    wP = jax.vmap(jax.grad(lambda a, x: JSP.gamma_inc(a, x)[0],
                           argnums=1))(aj, xj)
    wQ = jax.vmap(jax.grad(lambda a, x: JSP.gamma_inc(a, x)[1],
                           argnums=1))(aj, xj)
    np.testing.assert_allclose(gP.numpy(), np.asarray(wP), rtol=1e-10)
    np.testing.assert_allclose(gQ.numpy(), np.asarray(wQ), rtol=1e-10)


def test_gamma_inc_inv_p_derivative_matches_jax():
    a, p = _grid(A, PV)
    pt = torch.tensor(p, requires_grad=True)
    qt = torch.tensor(1 - p, requires_grad=True)
    x = TSP.gamma_inc_inv(torch.tensor(a), pt, qt)
    gp, gq = torch.autograd.grad(x.sum(), (pt, qt), allow_unused=True)
    aj, pj, qj = jnp.asarray(a), jnp.asarray(p), jnp.asarray(1 - p)
    wp, wq = jax.vmap(jax.grad(JSP.gamma_inc_inv, argnums=(1, 2)))(aj, pj,
                                                                   qj)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-10)
    assert np.all(np.asarray(wq) == 0)
    assert gq is None or bool((gq == 0).all())


def test_a_derivative_is_nan():
    a, x = _grid(A, X)
    at = torch.tensor(a, requires_grad=True)
    g, = torch.autograd.grad(TSP.gamma_inc(at, torch.tensor(x))[0].sum(), at)
    assert torch.isnan(g).all()
    at = torch.tensor(a, requires_grad=True)
    g, = torch.autograd.grad(TSP.gamma_inc_inv(
        at, torch.tensor(0.4), torch.tensor(0.6)).sum(), at)
    assert torch.isnan(g).all()
    # the JAX rule agrees
    assert np.isnan(float(jax.grad(
        lambda a: JSP.gamma_inc(a, 3.0)[0])(jnp.float64(2.5))))


def test_gradcheck_of_the_closed_form_derivatives():
    a = torch.tensor([0.7, 2.5, 4.0, 9.0], dtype=torch.float64)
    x = torch.tensor([0.4, 2.0, 6.0, 7.5], dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: TSP.gamma_inc(a, x), (x,))
    p = torch.tensor([0.05, 0.3, 0.6, 0.9], dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda p: TSP.gamma_inc_inv(a, p, 1 - p), (p,))


def test_torch_func_grad_reaches_the_rules():
    a = torch.tensor([1.5, 3.0], dtype=torch.float64)
    x = torch.tensor([0.8, 4.0], dtype=torch.float64)
    g = torch.func.grad(lambda x: TSP.gamma_inc(a, x)[0].sum())(x)
    want = jax.vmap(jax.grad(lambda a, x: JSP.gamma_inc(a, x)[0],
                             argnums=1))(jnp.asarray(a.numpy()),
                                         jnp.asarray(x.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-10)
    assert torch.isnan(torch.func.grad(
        lambda a: TSP.gamma_inc(a, x)[0].sum())(a)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_values_unchanged_by_the_rules(dtype):
    a, x = _grid(A, X)
    at, xt = torch.tensor(a, dtype=dtype), torch.tensor(x, dtype=dtype)
    plain = TSP.gamma_inc(at, xt)
    ruled = TSP.gamma_inc(at, xt.clone().requires_grad_(True))
    for u, v in zip(plain, ruled):
        assert torch.equal(u, v.detach())
    a, p = _grid(A, PV)
    at, pt = torch.tensor(a, dtype=dtype), torch.tensor(p, dtype=dtype)
    for n_iters in (4, 15):
        plain = TSP.gamma_inc_inv(at, pt, 1 - pt, n_iters=n_iters)
        ruled = TSP.gamma_inc_inv(at, pt.clone().requires_grad_(True),
                                  1 - pt, n_iters=n_iters)
        assert torch.equal(plain, ruled.detach())
