"""The examples that draw random numbers, against the JAX record
(``cloudmicrophysics_tpu_torch/data/examples_f64.json``), at float64 on
the CPU. The two packages' random streams differ, so:

* the three random Frostenberg variants run their full 1200 steps with
  the JAX script's own draws (``run_parcel``'s default key, split as its
  scan splits it) injected through ``parcel_tendencies``, and the
  deterministic mean variant through ``run()``: each summary matches the
  script's numbers at rtol 1e-6 (the floor of ``test_torch_examples.close``)
  and the lines printed from them are the script's;
* the stochastic box runs its 331 steps with the script's uniforms
  (``PRNGKey(7)``) injected through the scan body: every droplet freezes
  at the step it does in JAX, and the deterministic box matches at
  rtol 1e-6;
* the seeded runs of ``run()`` (the port's generator) fall within the
  record's band over 16 JAX keys: each number within the keys' range
  widened by half of it on either side.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu.models import box as JBOX
from cloudmicrophysics_tpu.parameters import aerosol_species as JSP
from cloudmicrophysics_tpu_torch.examples import box_alpert_knopf_2016 as BOX
from cloudmicrophysics_tpu_torch.examples import (
    parcel_frostenberg_immersion as FROST,
)
from cloudmicrophysics_tpu_torch.examples.common import print_summary
from cloudmicrophysics_tpu_torch.models import box as TBOX
from cloudmicrophysics_tpu_torch.models import parcel as TPM
from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Illite
from test_torch_examples import (
    BOX as JAX_BOX,
    RECORD,
    TPS,
    assert_lines,
    box_surface_areas,
    close,
)

RTOL = 1e-6
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def stored():
    return json.loads(RECORD.read_text())


def _jax_draws(key, n, shape):
    """The draws of ``n`` steps of a JAX scan that splits its key each
    step (``run_parcel``: normals; ``run_box_stochastic``: uniforms)."""
    normal = shape == (2,)

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, (jax.random.normal(sub, shape, jnp.float64) if normal
                   else jax.random.uniform(sub, shape, jnp.float64))

    return np.array(jax.lax.scan(body, key, None, length=n)[1])


def _parcel_with_draws(params, ic, t_end, draws):
    """``run_parcel``'s loop with the given draws."""
    dt = params.const_dt
    n = int(round(t_end / dt))
    y, dS = ic, torch.zeros_like(ic.S_l)
    rows = [ic]
    for i in range(n):
        t = np.float64(0.0) + np.float64(i) * np.float64(dt)
        dy = TPM.parcel_tendencies(params, y, t, dS,
                                   torch.from_numpy(draws[i]))
        y = TPM.ParcelState(*(v + dt * d for v, d in zip(y, dy)))
        rows.append(y)
        dS = dy.S_l
    return TPM.ParcelState(*(torch.stack(f) for f in zip(*rows)))


@pytest.mark.parametrize("variant", FROST.LABELS[1:])
def test_frostenberg_with_the_script_draws(stored, variant, capsys):
    ic, runs = FROST.setup("cpu")
    params = dict(runs)[variant]
    draws = _jax_draws(jax.random.PRNGKey(0), 1200, (2,))
    got = FROST.numbers(_parcel_with_draws(params, ic, 1200.0, draws))
    close(got, stored["full"]["parcel_frostenberg_immersion"][variant],
          RTOL, variant)
    # the lines printed from them are the script's
    capsys.readouterr()
    print_summary(variant, got)
    print(f"  frozen fraction end: {got['ff_end']:.3e}")
    want = stored["stdout"]["parcel_frostenberg_immersion"].splitlines()
    at = want.index(f"== {variant} ==")
    assert_lines(capsys.readouterr().out, "\n".join(want[at:at + 4]))


def test_stochastic_box_with_the_script_uniforms(stored):
    b = JAX_BOX
    n = 331
    Aj = box_surface_areas()
    np.testing.assert_array_equal(BOX.surface_areas(), Aj)
    u = _jax_draws(jax.random.PRNGKey(7), n, Aj.shape)
    want = np.asarray(JBOX.run_box_stochastic(
        jnp.float64(b["T0"]), Aj, 0.0, 3310.0, TPS, JSP.Illite(),
        b["cooling"], b["dt"], jax.random.PRNGKey(7))[2])
    A = torch.from_numpy(Aj)
    T = torch.tensor(b["T0"], dtype=torch.float64)
    frozen = torch.zeros(Aj.shape, dtype=torch.bool)
    got = []
    for i in range(n):
        T, frozen, _, n_ice, _ = TBOX._stochastic_step(
            BOX.TPS, Illite(), b["cooling"], b["dt"], A, T, frozen,
            torch.from_numpy(u[i]))
        got.append(int(n_ice))
    np.testing.assert_array_equal(got, want)
    rec = stored["full"]["box_alpert_knopf_2016"]
    assert got[-1] / b["N0"] == rec["ff_sto"]
    assert int(np.argmax(np.asarray(got) >= b["N0"] / 2)) == rec["half_sto"]


def _within(got, band, what):
    """Each number within the range of the 16 JAX keys widened by half of
    it on either side."""
    for k, (_, _, lo, hi) in band.items():
        pad = 0.5 * (hi - lo)
        assert lo - pad <= got[k] <= hi + pad, (what, k, got[k], lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_runs_fall_in_the_jax_band(stored, seed):
    out = FROST.run("cpu", seed=seed)
    rec = stored["full"]["parcel_frostenberg_immersion"]
    close(out[FROST.LABELS[0]], rec[FROST.LABELS[0]], RTOL, "mean")
    for label, band in stored["bands"]["parcel_frostenberg_immersion"] \
            .items():
        _within(out[label], band, label)
    box = BOX.run("cpu", seed=seed)
    _within(box, stored["bands"]["box_alpert_knopf_2016"], "box")
    rec = stored["full"]["box_alpert_knopf_2016"]
    close({k: box[k] for k in ("T_start", "T_end", "ff_det", "half_det")},
          {k: rec[k] for k in ("T_start", "T_end", "ff_det", "half_det")},
          RTOL, "deterministic box")


def test_seeded_runs_draw_from_their_generator():
    a, b = (BOX.run("cpu", seed=3)["half_sto"] for _ in range(2))
    assert a == b
