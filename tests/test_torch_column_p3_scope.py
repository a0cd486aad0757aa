"""The port's eager 2M + P3 column step against the JAX package's at the
P3 options the CUDA kernel (K5) takes beyond the defaults: ``SlopeConstant``
and ``NoAspectRatio`` (this file), the rain PSDs
(tests/test_torch_column_p3_rain.py), the quadrature orders
(tests/test_torch_column_p3_orders.py) and a wide order and level count
(tests/test_torch_column_p3_wide.py), one JAX compile each, two to a file.
On the card each option is a build of K5, held bit for bit to this eager
step (chip_smoke.py phase 19, tests/test_torch_cuda.py); here the eager
step is held to JAX at float64, cold and warm-started from a guess away
from the root, with test_torch_column_p3.py's tolerance: rtol 1e-9 with an
absolute floor of 1e-12 of the largest magnitude, and log lambda's
infinities coincide. Both packages refuse ice nucleation other than
``Frostenberg2023``, and so does the CUDA path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch.kernels import column_p3 as TK
from cloudmicrophysics_tpu_torch.models import column as TC
from test_torch_column_p3 import (  # noqa: E402
    ATOL_REL,
    DT,
    DZ,
    RTOL,
    TPS_J,
    TPS_T,
    _arrays,
    _assert_close,
    _assert_loglam,
    _jax_state,
    _torch_state,
)


def _unlimited_ice_rain(mp):
    return dataclasses.replace(mp, ice=dataclasses.replace(
        mp.ice, rain_pdf=dataclasses.replace(mp.ice.rain_pdf,
                                             is_limited=False)))


def params_pair(options):
    """The JAX parameters of ``options`` and the port's built from them."""
    options = dict(options)
    unlimited = options.pop("ice_rain_limited", True) is False
    mp_j = JP.microphysics_2m_params(with_ice=True, **options)
    if unlimited:
        mp_j = _unlimited_ice_rain(mp_j)
    mp_t = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(mp_j))
    return mp_j, mp_t


def jax_two_steps(mp_j, a):
    """One cold and one warm-started JAX step (one compile); the warm start
    is the cold log lambda plus ``a["guess_offset"]``."""
    def two(st, offset):
        new, ll = JC.step_column_p3(st, mp_j, TPS_J, DT, DZ)
        guess = ll + offset
        new2, ll2 = JC.step_column_p3(st, mp_j, TPS_J, DT, DZ, guess)
        return new, ll, guess, new2, ll2

    return jax.jit(two)(_jax_state(a), jnp.asarray(a["guess_offset"]))


def _solver_cells(got_ll, ref_ll):
    """The cells whose log lambda the port and JAX put more than rtol apart
    (both finite), and the cells their sedimentation reaches in one step:
    each such cell and the level below it, whose inflow it is."""
    got_ll, ref_ll = np.asarray(got_ll), np.asarray(ref_ll)
    fin = np.isfinite(ref_ll) & np.isfinite(got_ll)
    off = fin & ~np.isclose(got_ll, ref_ll, rtol=RTOL, atol=0.0)
    reached = off.copy()
    reached[:, :-1] |= off[:, 1:]
    return off, reached


def _assert_step(new, ll, ref, ll_ref, what, max_aside):
    """Hold one step to JAX's; at most ``max_aside`` cells whose fixed-trip
    Brent ends elsewhere are set aside with the cells below them."""
    off, reached = _solver_cells(ll.numpy(), ll_ref)
    assert int(off.sum()) <= max_aside, (what, np.argwhere(off).tolist())
    keep = ~reached
    np.testing.assert_array_equal(np.isinf(ll.numpy()), np.isinf(ll_ref),
                                  err_msg=what)
    fin = np.isfinite(np.asarray(ll_ref)) & keep
    np.testing.assert_allclose(ll.numpy()[fin], np.asarray(ll_ref)[fin],
                               rtol=RTOL, err_msg=f"{what} log lambda")
    for name, x, y in zip(ref._fields, new, ref):
        y = np.asarray(y)
        atol = ATOL_REL * float(np.max(np.abs(y)))
        np.testing.assert_allclose(x.numpy()[keep], y[keep], rtol=RTOL,
                                   atol=atol, err_msg=f"{what}: {name}")


def check_both_starts(mp_t, a, out, max_aside=0):
    """The port's cold and warm-started steps against JAX's ``out``. With
    ``max_aside`` 0 every cell is held (test_torch_column_p3.py's check);
    else up to that many cells per step may be set aside where the shape
    solve's fixed-trip Brent ends at another iterate (ROADMAP §3: the last
    bits of torch's and XLA's transcendentals flip one of its
    bisect-or-interpolate choices where the log mass moment kinks at a
    regime threshold), with the level below each, which its sedimentation
    reaches; every other cell is held to rtol 1e-9."""
    ref, ll_ref, guess, ref2, ll_ref2 = out
    new, ll = TC.step_column_p3(_torch_state(a), mp_t, TPS_T, DT, DZ)
    new2, ll2 = TC.step_column_p3(_torch_state(a), mp_t, TPS_T, DT, DZ,
                                  torch.tensor(np.asarray(guess)))
    if max_aside == 0:
        _assert_close(new, ref, "cold step")
        _assert_loglam(ll, ll_ref, "cold log lambda")
        _assert_close(new2, ref2, "warm step")
        _assert_loglam(ll2, ll_ref2, "warm log lambda")
    else:
        _assert_step(new, ll, ref, ll_ref, "cold step", max_aside)
        _assert_step(new2, ll2, ref2, ll_ref2, "warm step", max_aside)
    return ll


OPTIONS = {
    "SlopeConstant": dict(quadrature_order=4, slope_law="constant"),
    "NoAspectRatio": dict(quadrature_order=4, aspect_ratio="NoAspectRatio"),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_step_matches_jax_at_the_option(name):
    mp_j, mp_t = params_pair(OPTIONS[name])
    a = _arrays()
    ll = check_both_starts(mp_t, a, jax_two_steps(mp_j, a))
    # the option reached the port's step: a build of its own on the card
    v = TK.variant(mp_t, torch.float64)
    assert v != TK.variant(params_pair(dict(quadrature_order=4))[1],
                           torch.float64)
    assert torch.isfinite(ll[2:, 3:]).all()


def test_slope_constant_fixes_mu():
    """SlopeConstant's mu does not depend on lambda: the shape solve then
    changes log lambda against the power law."""
    _, mp_c = params_pair(OPTIONS["SlopeConstant"])
    _, mp_p = params_pair(dict(quadrature_order=4))
    st = _torch_state(_arrays())
    _, ll_c = TC.step_column_p3(st, mp_c, TPS_T, DT, DZ)
    _, ll_p = TC.step_column_p3(st, mp_p, TPS_T, DT, DZ)
    fin = torch.isfinite(ll_p)
    assert torch.equal(fin, torch.isfinite(ll_c))
    assert not torch.allclose(ll_c[fin], ll_p[fin])


def test_both_packages_refuse_mohler2006():
    """The JAX step hands ``mp.ice.ice_nucleation`` to the F23-only
    nucleation code, which needs ``T_freeze``: Mohler2006 fails there, in
    both packages; the CUDA path refuses it up front."""
    from cloudmicrophysics_tpu.parameters.ice_nucleation import (
        Mohler2006 as MohlerJ,
    )

    a = _arrays(ncol=2, nlev=4)
    mp_j = JP.microphysics_2m_params(with_ice=True, quadrature_order=4,
                                     ice_nucleation=MohlerJ())
    with pytest.raises(AttributeError, match="T_freeze"):
        jax.eval_shape(lambda st: JC.step_column_p3(st, mp_j, TPS_J, DT, DZ),
                       _jax_state(a))
    mp_t = TP.microphysics_2m_params(with_ice=True, quadrature_order=4,
                                     ice_nucleation=TP.Mohler2006())
    with pytest.raises(AttributeError, match="T_freeze"):
        TC.step_column_p3(_torch_state(a), mp_t, TPS_T, DT, DZ)
    with pytest.raises(NotImplementedError, match="Frostenberg2023"):
        TK._check_supported(mp_t, 4, torch.float32)
