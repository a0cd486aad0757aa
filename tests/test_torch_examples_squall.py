"""The squall example (``examples/column_squall_p3.py``) on the port's CPU
path, against the JAX record (``cloudmicrophysics_tpu_torch/data/
examples_f64.json``), in both configurations the record holds: the
script's (64 levels of 250 m, GL-8) and the full-width cell's (128 of
125 m, GL-16).

The rollout itself is unstable in the reference (``test_torch_examples``):
the JAX float64 rollout turns non-finite within a few steps, and the
float32 one depends on the last bit. So the port's step is held on the
states of JAX's float32 rollout instead, one step from each:

* float64: JAX's float64 step at rtol 1e-6, with an absolute floor of
  1e-12 of the field's largest magnitude, outside the cells set aside
  where the fixed-trip Brent stops at another iterate (log lambda 1e-6
  apart) and their vertical neighbours; at most ``ASIDE_F64`` cells of a
  step are set aside (0-6 seen);
* float32: against JAX's float64 step, per field at most twice JAX's own
  float32 error plus 1e-6, over every cell (the float32 solve stops
  after fewer trips than the float64 one, so its log lambda differs in
  most cells of the squall's ice).

The port's float32 rollout at two columns runs the script's 120 steps:
finite, both columns the same, its final ice water path within the range
of the record's 16 one-ulp-perturbed JAX columns, and ``main()`` prints
the script's lines. Its float64 rollout turns non-finite at the step
JAX's does, and ``run()`` raises there.
"""

import json

import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu_torch.examples import column_squall_p3 as SQ
from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3
from cloudmicrophysics_tpu_torch.parameters import microphysics_2m_params
from test_torch_examples import RECORD, assert_lines, squall_error

RTOL, ATOL_REL = 1e-6, 1e-12
ASIDE_F64 = 9        # cells set aside in one float64 step, at most (6 seen)


@pytest.fixture(scope="module")
def stored():
    return json.loads(RECORD.read_text())


def _steps(rec, dtype):
    """(input step, the port's step, JAX's float64 step) for each recorded
    state, one column."""
    mp = microphysics_2m_params(with_ice=True, quadrature_order=rec["order"])
    step = SQ.stepper(mp, rec["dt"], rec["dz"], "cpu")
    for k, inp, want in zip(rec["input_steps"], rec["inputs"],
                            rec["f64_step"]):
        st = ColumnStateP3(*(torch.tensor([inp["state"][f]], dtype=dtype)
                             for f in ColumnStateP3._fields))
        g = (None if inp["guess"] is None
             else torch.tensor([inp["guess"]], dtype=dtype))
        out, ll = step(st, g)
        want = (ColumnStateP3(*(np.asarray([want["state"][f]])
                                for f in ColumnStateP3._fields)),
                np.asarray([want["loglambda"]]))
        yield k, (ColumnStateP3(*(t.double().numpy() for t in out)),
                  ll.double().numpy()), want


@pytest.mark.parametrize("config", ["small", "full"])
def test_float64_step_matches_jax_on_the_rollout(stored, config):
    rec = stored["squall"][config]
    for k, got, want in _steps(rec, torch.float64):
        _, aside = squall_error(got, want)
        assert aside <= ASIDE_F64, (config, k, aside)
        mask = _aside_mask(got[1], want[1])
        for name, g, w in zip(ColumnStateP3._fields, got[0], want[0]):
            atol = ATOL_REL * float(np.max(np.abs(w)))
            np.testing.assert_allclose(g[~mask], w[~mask], rtol=RTOL,
                                       atol=atol,
                                       err_msg=f"{config} {k} {name}")


def _aside_mask(ll_got, ll_want):
    """The cells ``squall_error`` sets aside."""
    fin = np.isfinite(ll_got) & np.isfinite(ll_want)
    off = np.isinf(ll_got) != np.isinf(ll_want)
    off[fin] = (np.abs(ll_got[fin] - ll_want[fin])
                > 1e-6 * np.abs(ll_want[fin]))
    mask = off.copy()
    mask[..., 1:] |= off[..., :-1]
    mask[..., :-1] |= off[..., 1:]
    return mask


@pytest.mark.parametrize("config", ["small", "full"])
def test_float32_step_errs_as_jax_float32(stored, config):
    rec = stored["squall"][config]
    for (k, got, want), jax_err in zip(_steps(rec, torch.float32),
                                       rec["jax_float32_error"]):
        errs, _ = squall_error(got, want, set_aside=False)
        for name, e in errs.items():
            assert e <= 2 * jax_err[name] + 1e-6, (config, k, name, e,
                                                   jax_err[name])


def test_rollout_float32(stored, capsys):
    rec = stored["squall"]["small"]
    out = SQ.main(["--device", "cpu", "--ncol", "2"])
    assert_lines(capsys.readouterr().out, stored["stdout"]["column_squall_p3"],
                 numbers=False)
    assert out["steps"] == 120 and len(out["rows"]) == 7
    ens = rec["ensemble_iwp"]
    assert min(ens) <= out["IWP"] <= max(ens), (out["IWP"], ens)
    # the columns start identical and stay so
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = SQ.column_state(2, 64, 250.0, "cpu")
    st, ll, _ = SQ.rollout(st, SQ.stepper(mp, 2.0, 250.0, "cpu"), 10, 250.0)
    assert all(torch.equal(t[0], t[1]) for t in st)


@pytest.mark.parametrize("config", ["small", "full"])
def test_rollout_float64_turns_non_finite_at_the_jax_step(stored, config):
    rec = stored["squall"][config]
    mp = microphysics_2m_params(with_ice=True, quadrature_order=rec["order"])
    step = SQ.stepper(mp, rec["dt"], rec["dz"], "cpu")
    st, ll = SQ.column_state(1, rec["nlev"], rec["dz"], "cpu",
                             torch.float64), None
    for i in range(rec["f64_first_nonfinite_step"] + 1):
        st, ll = step(st, ll)
        finite = all(bool(torch.isfinite(t).all()) for t in st)
        assert finite == (i < rec["f64_first_nonfinite_step"]), (config, i)
    with pytest.raises(AssertionError, match="not finite"):
        SQ.run("cpu", torch.float64, ncol=1, nsteps=i + 1)


def test_col_chunks_is_refused_on_cuda():
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    with pytest.raises(ValueError, match="col_chunks"):
        SQ.stepper(mp, 2.0, 250.0, "cuda", col_chunks=2)
    out = SQ.run("cpu", ncol=2, nlev=16, nsteps=2, dz=1000.0, col_chunks=2)
    assert out["steps"] == 2
