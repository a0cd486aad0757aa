"""Parameter parity of the PyTorch port with the JAX package.

Both packages build their parameter structs with the same float64 host
arithmetic, so defaults must agree exactly, field by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu_torch.models.column import ColumnState


def _assert_same_tree(port, ref, path="root"):
    """Walk two parameter structs and require identical values."""
    if dataclasses.is_dataclass(ref):
        assert dataclasses.is_dataclass(port), path
        assert type(port).__name__ == type(ref).__name__, path
        ref_names = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == ref_names, path
        for name in ref_names:
            _assert_same_tree(getattr(port, name), getattr(ref, name),
                              f"{path}.{name}")
    elif isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif ref is None or isinstance(ref, str):
        assert port == ref, path
    else:
        assert isinstance(port, (int, float)), (path, type(port))
        assert port == float(ref), (path, port, ref)


@pytest.mark.parametrize("name", [
    "microphysics_1m_params", "terminal_velocity_params",
    "microphysics_0m_params", "chen2022_vel_type", "blk1m_vel_type",
    "ThermodynamicsParameters", "AirProperties", "WaterProperties",
    "Frostenberg2023",
])
def test_defaults_match_field_by_field(name):
    _assert_same_tree(getattr(TP, name)(), getattr(JP, name)())


def test_thermodynamics_derived_properties_match():
    port, ref = TP.ThermodynamicsParameters(), JP.ThermodynamicsParameters()
    for prop in ("R_d", "R_v", "Rv_over_Rd", "cp_d", "cv_d", "cv_v", "cv_l",
                 "cv_i", "LH_f0"):
        assert getattr(port, prop) == getattr(ref, prop), prop


OPTION_SETS = [
    ({}, {}),
    ({"Kessler1M": {"tau": 900.0, "q_threshold": 4e-4},
      "RainSnowAccretion": {"e": 0.9, "coeff_disp": 0.3}}, {}),
    ({"PrescribedNd": {"tau": 500.0, "Nc": 2e8}},
     {"rain_autoconversion": "PrescribedNd",
      "snow_autoconversion": "WithSupersaturation",
      "snow_deposition_sublimation": "SublimationOnly"}),
    ({"TemperatureDependent": {"tau_relax": 20.0}},
     {"cloud_ice_formation": "TemperatureDependent", "snow_melt": None,
      "cloud_liquid_rain_accretion": None}),
    ({}, {"cloud_liquid_formation": None, "rain_snow_accretion": None,
          "snow_autoconversion": None}),
]


@pytest.mark.parametrize("overrides,options", OPTION_SETS)
def test_from_tree_matches_own_construction(overrides, options):
    ref = JP.microphysics_1m_params(process_overrides=overrides, **options)
    port = TP.from_tree(TP.Microphysics1MParams, dataclasses.asdict(ref))
    assert port == TP.microphysics_1m_params(process_overrides=overrides,
                                             **options)
    _assert_same_tree(port, ref)


def test_from_tree_takes_every_float():
    # a JAX set whose floats all differ from the defaults (as calibration
    # would leave it): from_tree must carry every one across
    ref = JP.ThermodynamicsParameters()
    tree = {k: v * 1.5 for k, v in dataclasses.asdict(ref).items()}
    port = TP.from_tree(TP.ThermodynamicsParameters, tree)
    _assert_same_tree(port, JP.ThermodynamicsParameters(**tree))
    tv = TP.from_tree(TP.TerminalVelocityParams,
                      dataclasses.asdict(JP.terminal_velocity_params()))
    _assert_same_tree(tv, JP.terminal_velocity_params())


def test_from_tree_accepts_numpy_leaves():
    tree = dataclasses.asdict(JP.microphysics_1m_params())
    tree["air_properties"]["K_therm"] = np.float32(0.025)
    tree["process_params"]["rain_autoconversion"]["tau"] = np.array(800.0)
    port = TP.from_tree(TP.Microphysics1MParams, tree)
    assert port.air_properties.K_therm == float(np.float32(0.025))
    assert port.process_params.rain_autoconversion.tau == 800.0
    assert isinstance(port.process_params.rain_autoconversion.tau, float)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_state_from_numpy(dtype):
    rng = np.random.default_rng(3)
    arrays = {name: rng.random((4, 5)) for name in ColumnState._fields}
    st = TP.column_state_from_numpy(arrays, dtype=dtype)
    assert isinstance(st, ColumnState)
    for name, t in zip(ColumnState._fields, st):
        assert t.dtype == dtype and t.shape == (4, 5) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arrays[name].astype(
            t.numpy().dtype))
