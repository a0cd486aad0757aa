"""Forward-mode AD and ``vmap`` of the port against the JAX package's
(counterpart of tests/test_ad_compat.py; reference
test/ad_compat_tests.jl).

* ``gamma_inc`` and ``gamma_inc_inv`` under ``torch.func.jvp``, ``jacfwd``
  and ``vmap`` against ``jax.jvp``, ``jax.jacfwd`` and ``jax.vmap``: the
  closed-form tangent in ``x`` (``p`` for the inverse), NaN for any tangent
  in ``a`` (also a zero one), and values bit-identical to the plain call.
* The Jacobian of the fused 2M + P3 ``bulk_tendencies_2m`` over the eight
  species with log lambda held fixed, ``vmap``-ed over the four regimes of
  tests/test_ad_compat.py and its zero-rain state, against
  ``jax.vmap(jax.jacfwd(...))`` on the same states.

Tolerances. The incomplete gammas: rtol 1e-9 at float64, 1e-5 at float32.
The Jacobians, per row (each row is one tendency; number rows dwarf mass
rows by ~10 orders of magnitude): at float64, rtol 1e-9 with an absolute
floor of 1e-12 of the row's largest magnitude, except two rows held at
rtol 1e-5 with a floor of 2e-3 of it: the rain-mass tendency's in the
ice-heavy and zero-rain states, where rain is at or below 1e-12 kg/kg and
the entries are differences of terms that cancel (measured: 2.5e-6
relative, and 1.6e-3 of the row for entries of ~1e-16 against JAX's
~1e-22). At float32 both packages' Jacobians are far from the float64 one
(up to 100 % of a row: the float32 shape solve lands on another log
lambda), so the float32 rule is the P3 ladder's: per row, the port's
largest error against JAX's float64 Jacobian is at most twice JAX's own
float32 error, plus 1e-6 of the row (measured ratios 0.0008-1.0, and 3.6
where both errors are ~1e-7 of the row).

The kinks of ``max(x, 0)`` are where the species sit at 0 (ice in the
warm-rain state, rain in the zero-rain state): there both packages take
1/2 of the tangent (``jnp.maximum``'s rule, which the port's
``clamp_to_nonneg`` follows).
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
from cloudmicrophysics_tpu.utils import special as JS
from cloudmicrophysics_tpu_torch.models.tendencies import bulk_tendencies_2m as TB
from cloudmicrophysics_tpu_torch.utils import special as TS

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_ad_compat import REGIMES  # noqa: E402

DTYPES = ("float32", "float64")
RTOL = {"float32": 1e-5, "float64": 1e-9}
# (state, row) of the float64 Jacobian held at rtol 1e-5 and a floor of
# 2e-3 of the row: rain at or below 1e-12 kg/kg, the rain-mass row
LOOSE = {("ice heavy", 2), ("zero rain", 2)}

A = [0.3, 1.5, 2.5, 4.0, 10.0]
X = [0.05, 0.5, 1.0, 3.0, 12.0]
P = [1e-4, 0.2, 0.5, 0.9, 0.999]


def _pair(values, dtype):
    return (jnp.asarray(values, dtype),
            torch.tensor(values, dtype=getattr(torch, dtype)))


def _close(out, ref, dtype, what):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=RTOL[dtype], atol=0, err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gamma_inc_jvp_matches_jax(dtype):
    aj, at = _pair(A, dtype)
    xj, xt = _pair(X, dtype)
    (Pj, Qj), (dPj, dQj) = jax.jvp(lambda x: JS.gamma_inc(aj, x), (xj,),
                                   (jnp.ones_like(xj),))
    (Pt, Qt), (dPt, dQt) = torch.func.jvp(lambda x: TS.gamma_inc(at, x),
                                          (xt,), (torch.ones_like(xt),))
    # the primal is the plain call's, bit for bit
    plain = TS.gamma_inc(at, xt)
    assert torch.equal(Pt, plain[0]) and torch.equal(Qt, plain[1])
    _close(Pt, Pj, dtype, "P")
    _close(dPt, dPj, dtype, "dP/dx")
    _close(dQt, dQj, dtype, "dQ/dx")
    # a tangent in a, even a zero one, is NaN in both packages
    for seed in (1.0, 0.0):
        _, (dPj, dQj) = jax.jvp(lambda a: JS.gamma_inc(a, xj), (aj,),
                                (jnp.full_like(aj, seed),))
        _, (dPt, dQt) = torch.func.jvp(lambda a: TS.gamma_inc(a, xt), (at,),
                                       (torch.full_like(at, seed),))
        for t in (dPj, dQj, dPt, dQt):
            assert np.isnan(np.asarray(t)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gamma_inc_jacfwd_and_vmap_match_jax(dtype):
    aj, at = _pair(A, dtype)
    xj, xt = _pair(X, dtype)
    Jj = jax.jacfwd(lambda x: JS.gamma_inc(aj, x)[1])(xj)
    Jt = torch.func.jacfwd(lambda x: TS.gamma_inc(at, x)[1])(xt)
    _close(Jt, Jj, dtype, "jacfwd Q")
    assert np.count_nonzero(np.asarray(Jt) - np.diag(np.diag(Jt))) == 0
    # vmap over a batch of (a, x) rows, each row a call of its own
    aa = np.outer(np.ones(3), A) * np.array([[1.0], [0.5], [2.0]])
    xx = np.outer(np.ones(3), X)
    (Pj, Qj) = jax.vmap(JS.gamma_inc)(*(jnp.asarray(v, dtype)
                                        for v in (aa, xx)))
    at2, xt2 = (torch.tensor(v, dtype=getattr(torch, dtype))
                for v in (aa, xx))
    (Pt, Qt) = torch.func.vmap(TS.gamma_inc)(at2, xt2)
    plain = TS.gamma_inc(at2, xt2)
    assert torch.equal(Pt, plain[0]) and torch.equal(Qt, plain[1])
    _close(Pt, Pj, dtype, "vmap P")
    _close(Qt, Qj, dtype, "vmap Q")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gamma_inc_inv_jvp_jacfwd_vmap_match_jax(dtype):
    aj, at = _pair(A, dtype)
    pj, pt = _pair(P, dtype)
    xj, dxj = jax.jvp(lambda p: JS.gamma_inc_inv(aj, p, 1 - p), (pj,),
                      (jnp.ones_like(pj),))
    xt, dxt = torch.func.jvp(lambda p: TS.gamma_inc_inv(at, p, 1 - p), (pt,),
                             (torch.ones_like(pt),))
    assert torch.equal(xt, TS.gamma_inc_inv(at, pt, 1 - pt))
    _close(xt, xj, dtype, "x")
    _close(dxt, dxj, dtype, "dx/dp")
    Jj = jax.jacfwd(lambda p: JS.gamma_inc_inv(aj, p, 1 - p))(pj)
    Jt = torch.func.jacfwd(lambda p: TS.gamma_inc_inv(at, p, 1 - p))(pt)
    _close(Jt, Jj, dtype, "jacfwd x")
    _, dxj = jax.jvp(lambda a: JS.gamma_inc_inv(a, pj, 1 - pj), (aj,),
                     (jnp.zeros_like(aj),))
    _, dxt = torch.func.jvp(lambda a: TS.gamma_inc_inv(a, pt, 1 - pt), (at,),
                            (torch.zeros_like(at),))
    assert np.isnan(np.asarray(dxj)).all() and torch.isnan(dxt).all()
    pp = np.outer([1.0, 0.5], P)
    xj = jax.vmap(lambda a, p: JS.gamma_inc_inv(a, p, 1 - p))(
        jnp.broadcast_to(aj, pp.shape), jnp.asarray(pp, dtype))
    pt2 = torch.tensor(pp, dtype=getattr(torch, dtype))
    xt = torch.func.vmap(lambda a, p: TS.gamma_inc_inv(a, p, 1 - p))(
        at.expand(pt2.shape), pt2)
    _close(xt, xj, dtype, "vmap x")


def test_gamma_inc_reverse_mode_still_matches_forward_mode():
    at = torch.tensor(A, dtype=torch.float64)
    xt = torch.tensor(X, dtype=torch.float64)
    fwd = torch.func.jacfwd(lambda x: TS.gamma_inc(at, x)[0])(xt)
    rev = torch.func.jacrev(lambda x: TS.gamma_inc(at, x)[0])(xt)
    assert torch.equal(fwd, rev)


@pytest.mark.parametrize("api", ["forward_ad", "jvp", "jacrev"])
def test_clamp_to_nonneg_takes_half_at_zero_under_every_ad_api(api):
    # jnp.maximum(x, 0)'s derivative: 1 above 0, 1/2 at 0, 0 below, whether
    # the tangent comes from dual tensors, torch.func or reverse mode
    values = [-1.0, 0.0, 2.0]
    xj = jnp.asarray(values, "float64")
    ref = jax.jvp(lambda x: jnp.maximum(x, 0.0), (xj,),
                  (jnp.ones(3, "float64"),))[1]
    xt = torch.tensor(values, dtype=torch.float64)
    ones = torch.ones(3, dtype=torch.float64)
    if api == "forward_ad":
        import torch.autograd.forward_ad as fwAD
        with fwAD.dual_level():
            out = fwAD.unpack_dual(TS.clamp_to_nonneg(
                fwAD.make_dual(xt, ones))).tangent
    elif api == "jvp":
        out = torch.func.jvp(TS.clamp_to_nonneg, (xt,), (ones,))[1]
    else:
        out = torch.diagonal(torch.func.jacrev(TS.clamp_to_nonneg)(xt))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(TS.clamp_to_nonneg(xt), torch.clamp(xt, min=0.0))


# the four regimes of tests/test_ad_compat.py and its zero-rain state
STATES = dict(REGIMES)
STATES["zero rain"] = dict(rho=0.45, T=233.0, q_tot=0.003,
                           x=[1e-6, 1e6, 0, 0, 8e-4, 5e5, 5e-4, 9e-7],
                           loglam=None)


@pytest.fixture(scope="module")
def mps():
    mp_j = JP.microphysics_2m_params(with_ice=True, is_limited=True)
    return mp_j, TP.from_tree(TP.Microphysics2MParams,
                              dataclasses.asdict(mp_j))


def _batch(mp_j, dtype):
    """The states as a batch (rho, T, q_tot, log lambda, x) in numpy, log
    lambda the shape solve's on each state (or the regime's own)."""
    cols = [np.array([s[k] for s in STATES.values()], dtype)
            for k in ("rho", "T", "q_tot")]
    x = np.array([s["x"] for s in STATES.values()], dtype)
    ll = []
    for s, rho, xs in zip(STATES.values(), cols[0], x):
        if s["loglam"] is not None:
            ll.append(s["loglam"])
            continue
        r, q = jnp.asarray(rho, dtype), jnp.asarray(xs, dtype)
        ll.append(float(JP3.get_distribution_loglambda_from_prognostic(
            mp_j.ice.scheme, r * q[4], r * q[5], r * q[6], r * q[7])))
    return (*cols, np.array(ll, dtype), x)


def _f_t(mp_t):
    tps_t = TP.ThermodynamicsParameters()

    def f(rho, T, q_tot, ll, x):
        return torch.stack(tuple(TB(mp_t, tps_t, rho, T, q_tot, *x.unbind(0),
                                    ll)))
    return f


@pytest.fixture(scope="module")
def jax_jacobians(mps):
    """``jax.vmap(jax.jacfwd(...))`` of the tendencies over the states, at
    each dtype, as float64 numpy arrays (one compile each)."""
    mp_j = mps[0]
    tps_j = JP.ThermodynamicsParameters()

    def f_j(rho, T, q_tot, ll, x):
        return jnp.stack(tuple(JB(mp_j, tps_j, rho, T, q_tot, *x, ll)))

    jac = jax.jit(jax.vmap(jax.jacfwd(f_j, argnums=4)))
    return {dt: np.asarray(jac(*_batch(mp_j, dt)), np.float64)
            for dt in DTYPES}


def _torch_jacobian(mps, dtype):
    """The port's ``vmap(jacfwd(...))`` over the states, and the check that
    its primal under ``vmap`` is the batch of plain calls."""
    f_t = _f_t(mps[1])
    args = [torch.tensor(b) for b in _batch(mps[0], dtype)]
    out = torch.func.vmap(torch.func.jacfwd(f_t, argnums=4))(*args)
    values = torch.func.vmap(f_t)(*args)
    for i in range(len(STATES)):
        assert torch.equal(values[i], f_t(*(a[i] for a in args)))
    assert out.shape == (len(STATES), 8, 8)
    assert bool(torch.isfinite(out).all())
    return out.numpy().astype(np.float64)


def test_bulk_tendencies_2m_jacobian_matches_jax_f64(mps, jax_jacobians):
    out, ref = _torch_jacobian(mps, "float64"), jax_jacobians["float64"]
    for i, name in enumerate(STATES):
        for row in range(8):
            scale = float(np.abs(ref[i, row]).max())
            rtol, floor = RTOL["float64"], 1e-12
            if (name, row) in LOOSE:
                rtol, floor = 1e-5, 2e-3
            np.testing.assert_allclose(
                out[i, row], ref[i, row], rtol=rtol, atol=floor * scale,
                err_msg=f"float64 {name}: row {row}")


def test_bulk_tendencies_2m_jacobian_f32_error_is_jax_f32_error(
        mps, jax_jacobians):
    out = _torch_jacobian(mps, "float32")
    ref, jax32 = jax_jacobians["float64"], jax_jacobians["float32"]
    for i, name in enumerate(STATES):
        for row in range(8):
            scale = float(np.abs(ref[i, row]).max())
            if scale == 0:
                assert not out[i, row].any(), f"{name}: row {row}"
                continue
            err = float(np.abs(out[i, row] - ref[i, row]).max()) / scale
            err_jax = float(np.abs(jax32[i, row] - ref[i, row]).max()) / scale
            assert err <= 2 * err_jax + 1e-6, (
                f"float32 {name}: row {row}: {err:.3e} against JAX's "
                f"{err_jax:.3e}")
