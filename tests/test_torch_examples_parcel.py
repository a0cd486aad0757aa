"""The port's deterministic parcel examples against the JAX record
(``cloudmicrophysics_tpu_torch/data/examples_f64.json``), at float64 on
the CPU, through each module's ``main()``:

* the numbers ``run()`` returns match the record at rtol 1e-6 (the parcel
  tests' tolerance of a whole trajectory), with an absolute floor of 1e-12
  of the condensate present for the liquid and ice contents and numbers
  (``test_torch_examples.close``), at full length; NonEq and Tully at the
  record's cut lengths (each run's first 2000 steps), which
  ``chip_smoke.py`` runs too;
* ``main()`` prints the JAX script's lines (the cut runs: the same text,
  their numbers being another run's);
* ``parcel_liquid_only`` reproduces Rogers (1975) Fig. 1 within 0.1 %.
"""

import functools
import importlib
import json

import pytest

from test_torch_examples import RECORD, assert_lines, close

RTOL = 1e-6
FULL = ("parcel_liquid_only", "parcel_aerosol_activation",
        "parcel_immersion_freezing", "parcel_deposition_nucleation",
        "parcel_p3_ice_nuc", "parcel_p3_vs_activitybased",
        "parcel_jensen_2022")
CUT = ("parcel_noneq", "parcel_tully_2023")


@pytest.fixture(scope="module")
def stored():
    return json.loads(RECORD.read_text())


def _main(name, capsys, monkeypatch, **cut):
    mod = importlib.import_module(f"cloudmicrophysics_tpu_torch.examples."
                                  f"{name}")
    if cut:
        monkeypatch.setattr(mod, "run", functools.partial(mod.run, **cut))
    capsys.readouterr()
    out = mod.main(["--device", "cpu"])
    return out, capsys.readouterr().out


@pytest.mark.parametrize("name", FULL)
def test_example_matches_the_jax_record(stored, name, capsys, monkeypatch):
    out, text = _main(name, capsys, monkeypatch)
    worst = []
    close(out, stored["full"][name], RTOL, name, worst)
    assert_lines(text, stored["stdout"][name])
    print(name, "largest relative error", max(worst, default=(0.0, "")))


@pytest.mark.parametrize("name", CUT)
def test_cut_example_matches_the_jax_record(stored, name, capsys,
                                            monkeypatch):
    out, text = _main(name, capsys, monkeypatch,
                      **stored["cut_kwargs"][name])
    worst = []
    close(out, stored["cut"][name], RTOL, name, worst)
    assert_lines(text, stored["stdout"][name], numbers=False)
    print(name, "largest relative error", max(worst, default=(0.0, "")))


def test_liquid_only_reproduces_rogers_1975():
    from cloudmicrophysics_tpu_torch.examples import parcel_liquid_only

    out = parcel_liquid_only.run("cpu")
    assert out["rogers_max_err"] < 0.1
    assert out["steps"] == 80
