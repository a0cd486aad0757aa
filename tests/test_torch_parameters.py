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
from cloudmicrophysics_tpu_torch.models.column import ColumnState, ColumnState2M


def _assert_same_tree(port, ref, path="root"):
    """Walk two parameter structs and require identical values."""
    if type(ref).__name__ == "Tabulated":
        assert type(port).__name__ == "Tabulated" and port.n == ref.n, path
        for a, b in zip(port.nodes_weights(), ref.nodes_weights()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=path)
    elif dataclasses.is_dataclass(ref):
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
    "Frostenberg2023", "microphysics_2m_params", "sb2006",
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
    st = TP.column_state_from_numpy(arrays, device="cpu", dtype=dtype)
    assert isinstance(st, ColumnState)
    for name, t in zip(ColumnState._fields, st):
        assert t.dtype == dtype and t.shape == (4, 5) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arrays[name].astype(
            t.numpy().dtype))


M2_OPTIONS = [dict(is_limited=lim, rain_velocity=vel)
              for lim in (True, False) for vel in ("sb2006", "chen2022")]


@pytest.mark.parametrize("options", M2_OPTIONS)
def test_m2_params_match_field_by_field(options):
    ref = JP.microphysics_2m_params(**options)
    port = TP.microphysics_2m_params(**options)
    _assert_same_tree(port, ref)
    assert type(port.warm_rain.terminal_velocity).__name__ == \
        type(ref.warm_rain.terminal_velocity).__name__


@pytest.mark.parametrize("options", M2_OPTIONS)
def test_m2_from_tree_matches_own_construction(options):
    ref = JP.microphysics_2m_params(**options)
    port = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(ref))
    assert port == TP.microphysics_2m_params(**options)
    _assert_same_tree(port, ref)


def test_m2_from_tree_takes_every_float():
    ref = JP.microphysics_2m_params(rain_velocity="chen2022")
    tree = dataclasses.asdict(ref)
    tree["warm_rain"]["seifert_beheng"]["accr"]["kcr"] = 6.5
    tree["warm_rain"]["seifert_beheng"]["pdf_r"]["xr_max"] = np.float32(4e-6)
    tree["warm_rain"]["condevap"]["tau_relax"] = np.array(12.0)
    tree["warm_rain"]["terminal_velocity"]["b_rho"] = 0.04
    port = TP.from_tree(TP.Microphysics2MParams, tree)
    sb = port.warm_rain.seifert_beheng
    assert sb.accr.kcr == 6.5 and sb.pdf_r.xr_max == float(np.float32(4e-6))
    assert port.warm_rain.condevap.tau_relax == 12.0
    assert port.warm_rain.terminal_velocity.b_rho == 0.04
    bad = dataclasses.asdict(ref)
    bad["warm_rain"]["terminal_velocity"] = {"v": 1.0}
    with pytest.raises(ValueError, match="no rain velocity type"):
        TP.from_tree(TP.Microphysics2MParams, bad)


def test_m2_factories_match():
    for name in ("kk2000", "b1994", "tc1980", "evaporation_sb2006",
                 "cloud_pdf_sb2006"):
        _assert_same_tree(getattr(TP.m2, name)(), getattr(JP.m2, name)())
    _assert_same_tree(TP.m2.LD2004(), JP.m2.LD2004())
    _assert_same_tree(TP.sb2006(is_limited=False, accr={"kcr": 4.0}),
                      JP.sb2006(is_limited=False, accr={"kcr": 4.0}))


def test_m2_with_ice_waits_for_p3():
    # the P3 ice container is ported: with_ice=True builds it, as in JAX
    port = TP.microphysics_2m_params(with_ice=True)
    assert isinstance(port.ice, TP.P3IceParams)
    _assert_same_tree(port, JP.microphysics_2m_params(with_ice=True))
    with pytest.raises(ValueError, match="rain_velocity"):
        TP.microphysics_2m_params(rain_velocity="stokes")


P3_OPTIONS = [dict(quadrature_order=o) for o in (4, 8, 16)] + [
    dict(quadrature_order=8, slope_law="constant"),
    dict(quadrature_order=10, aspect_ratio="NoAspectRatio"),
]


@pytest.mark.parametrize("options", P3_OPTIONS)
def test_p3_params_match_field_by_field(options):
    ref = JP.microphysics_2m_params(with_ice=True, **options)
    port = TP.microphysics_2m_params(with_ice=True, **options)
    _assert_same_tree(port, ref)
    assert type(port.ice.scheme.slope).__name__ == \
        type(ref.ice.scheme.slope).__name__
    # the tables of the order's rule, as the JAX package tabulates them
    assert port.ice.quad.y.shape == (options["quadrature_order"], 1, 1)


@pytest.mark.parametrize("options", P3_OPTIONS)
def test_p3_from_tree_round_trip(options):
    ref = JP.microphysics_2m_params(with_ice=True, is_limited=False,
                                    rain_velocity="chen2022", **options)
    port = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(ref))
    assert port == TP.microphysics_2m_params(
        with_ice=True, is_limited=False, rain_velocity="chen2022", **options)
    _assert_same_tree(port, ref)
    # the port's own tree round-trips as well
    assert TP.from_tree(TP.Microphysics2MParams,
                        dataclasses.asdict(port)) == port


def test_p3_from_tree_takes_every_float():
    ref = JP.microphysics_2m_params(with_ice=True, quadrature_order=8)
    tree = dataclasses.asdict(ref)
    tree["ice"]["scheme"]["tau_wet"] = 50.0
    tree["ice"]["scheme"]["slope"]["mu_max"] = np.float32(5.0)
    tree["ice"]["numadj"]["x_max"] = np.array(2e-5)
    tree["ice"]["ice_nucleation"]["sigma"] = 1.5
    port = TP.from_tree(TP.Microphysics2MParams, tree)
    assert port.ice.scheme.tau_wet == 50.0
    assert port.ice.scheme.slope.mu_max == 5.0
    assert port.ice.numadj.x_max == 2e-5
    assert port.ice.ice_nucleation.sigma == 1.5
    bad = dataclasses.asdict(ref)
    bad["ice"]["scheme"]["slope"] = {"k": 1.0}
    with pytest.raises(ValueError, match="no slope law"):
        TP.from_tree(TP.Microphysics2MParams, bad)


def test_p3_ice_params_direct_construction_fills_derived_fields():
    ice = TP.P3IceParams(
        scheme=TP.parameters_p3(), terminal_velocity=TP.chen2022_vel_type(),
        cloud_pdf=TP.m2.cloud_pdf_sb2006(),
        rain_pdf=TP.m2.RainParticlePDF_SB2006(),
        ice_nucleation=TP.Frostenberg2023(), rain_freezing=TP.RainFreezing(),
        inp_depletion_model=TP.NIceProxyDepletion(), quadrature_order=8)
    assert ice.numadj == TP.IceNumberAdjustment() and ice.quad.n == 8
    _assert_same_tree(ice, JP.p3.P3IceParams(
        scheme=JP.parameters_p3(), terminal_velocity=JP.chen2022_vel_type(),
        cloud_pdf=JP.m2.cloud_pdf_sb2006(),
        rain_pdf=JP.m2.RainParticlePDF_SB2006(),
        ice_nucleation=JP.Frostenberg2023(),
        rain_freezing=JP.ice_nucleation.RainFreezing(),
        inp_depletion_model=JP.ice_nucleation.NIceProxyDepletion(),
        quadrature_order=8))


def test_ice_nucleation_params_match_field_by_field():
    _assert_same_tree(TP.ice_nucleation_parameters(),
                      JP.ice_nucleation_parameters())
    for name in ("RainFreezing", "NIceProxyDepletion", "Mohler2006",
                 "Koop2000", "MorrisonMilbrandt2014"):
        _assert_same_tree(getattr(TP, name)(),
                          getattr(JP.ice_nucleation, name)())


def test_column_state_p3_from_numpy():
    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

    rng = np.random.default_rng(5)
    arrays = {name: rng.random((2, 7)) for name in ColumnStateP3._fields}
    st = TP.column_state_p3_from_numpy(arrays, device="cpu",
                                       dtype=torch.float64)
    assert isinstance(st, ColumnStateP3) and len(st) == 11
    for name, t in zip(ColumnStateP3._fields, st):
        np.testing.assert_array_equal(t.numpy(), arrays[name])


def test_column_state_2m_from_numpy():
    rng = np.random.default_rng(4)
    arrays = {name: rng.random((3, 6)) for name in ColumnState2M._fields}
    st = TP.column_state_2m_from_numpy(arrays, device="cpu",
                                       dtype=torch.float32)
    assert isinstance(st, ColumnState2M)
    for name, t in zip(ColumnState2M._fields, st):
        assert t.dtype == torch.float32 and t.shape == (3, 6)
        np.testing.assert_array_equal(t.numpy(),
                                      arrays[name].astype(np.float32))
