"""The port's flat-TOML override pipeline against the JAX package, on the
CPU: every case of ``tests/test_config.py`` on the port, the structs each
shipped override set builds walked field by field against the JAX
package's (exact: both packages derive them with the same float64 host
arithmetic), and the port's copies of the TOML files byte for byte."""

import math
from pathlib import Path

import pytest

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.parameters import config as JC
from cloudmicrophysics_tpu_torch.parameters import config as TC
from test_torch_parameters import _assert_same_tree

SETS = ("CliMA_1M", "ARG2000", "SB2006_limiters")
FACTORIES = ("microphysics_1m_params_from_overrides",
             "aerosol_activation_params_from_overrides",
             "sb2006_from_overrides",
             "microphysics_2m_params_from_overrides")


class TestLoader:
    def test_table_form(self):
        ov = TP.load_toml_overrides(
            "[rain_autoconversion_timescale]\nvalue = 2500.0\n")
        assert ov == {"rain_autoconversion_timescale": 2500.0}

    def test_flat_form(self):
        ov = TP.load_toml_overrides(
            "rain_ventilation_coefficient_b = 0.9\n"
            "[rain_autoconversion_timescale]\nvalue = 2500.0\n")
        assert ov == {"rain_ventilation_coefficient_b": 0.9,
                      "rain_autoconversion_timescale": 2500.0}

    def test_path_forms(self):
        path = TP.calibrated_toml_path("ARG2000")
        assert TP.load_toml_overrides(path) == TP.load_toml_overrides(
            str(path)) == TP.calibrated_overrides("ARG2000")

    def test_missing_value_key_raises(self):
        with pytest.raises(ValueError, match="no 'value' key"):
            TP.load_toml_overrides("[rain_autoconversion_timescale]\nx = 1\n")

    def test_unknown_name_strict(self):
        with pytest.raises(KeyError, match="unknown override parameter"):
            TP.microphysics_1m_params_from_overrides({"not_a_param": 1.0})
        mp = TP.microphysics_1m_params_from_overrides({"not_a_param": 1.0},
                                                      strict=False)
        assert mp == TP.microphysics_1m_params()

    def test_shipped_sets_load(self):
        for name in SETS:
            assert len(TP.calibrated_overrides(name)) >= 4
        with pytest.raises(FileNotFoundError):
            TP.calibrated_overrides("nope")


class TestCliMA1M:
    def test_calibrated_set_rederives_precomputes(self):
        mp = TP.microphysics_1m_params_from_overrides(
            TP.calibrated_overrides("CliMA_1M"))
        assert mp.process_params.rain_autoconversion.tau == pytest.approx(
            13353.890619526366)
        assert mp.process_params.cloud_liquid_formation.tau_relax == \
            pytest.approx(39.688722877923894)
        assert mp.precip.rain.area.chia == pytest.approx(16.60537462650898)
        assert mp.precip.rain.area.da == pytest.approx(2.997519288341676)
        assert mp.precip.rain.vent.b == pytest.approx(0.9779279811508783)
        vr = mp.terminal_velocity.rain
        assert vr.chiv == pytest.approx(0.20454276658307452)
        assert vr.dv == pytest.approx(0.22763691994393714)
        assert vr.gamma_term == pytest.approx(
            math.gamma(3.0 + 0.5 + 0.0 + 0.22763691994393714 + 1))
        assert vr.gamma_vent == pytest.approx(
            math.gamma((0.5 + 0.22763691994393714 + 5) / 2))

    def test_untouched_fields_keep_defaults(self):
        mp = TP.microphysics_1m_params_from_overrides(
            {"rain_autoconversion_timescale": 2500.0})
        base = TP.microphysics_1m_params()
        assert mp.process_params.rain_autoconversion.tau == 2500.0
        assert mp.precip == base.precip
        assert mp.terminal_velocity == base.terminal_velocity

    def test_calibrated_block_reaches_the_kernel_parameters(self):
        # the column step's kernel block reads the rain velocity
        # coefficients from mp.terminal_velocity, so a calibrated set
        # builds another block (another build of the kernel)
        from cloudmicrophysics_tpu_torch.kernels.column1m import (
            PARAM_NAMES,
            kernel_params,
        )

        tps, tv = TP.ThermodynamicsParameters(), TP.terminal_velocity_params()
        mp = TP.microphysics_1m_params_from_overrides(
            TP.calibrated_overrides("CliMA_1M"))
        assert mp.processes == TP.microphysics_1m_params().processes
        base = kernel_params(TP.microphysics_1m_params(), tps, tv)
        cal = kernel_params(mp, tps, tv)
        assert len(cal) == len(PARAM_NAMES) and not bool((cal == base).all())
        vel_only = TP.microphysics_1m_params_from_overrides({
            "rain_terminal_velocity_size_relation_coefficient_chiv": 0.2})
        assert not bool((kernel_params(vel_only, tps, tv) == base).all())


class TestARG2000:
    def test_calibrated_fit(self):
        ap = TP.aerosol_activation_params_from_overrides(
            TP.calibrated_overrides("ARG2000"))
        assert ap.f1 == pytest.approx(0.26583888195264627)
        assert ap.p2 == pytest.approx(0.7578626397779737)
        assert ap.sigma == 0.072


class TestSB2006:
    def test_limiter_overrides(self):
        sb = TP.sb2006_from_overrides(
            TP.calibrated_overrides("SB2006_limiters"))
        assert sb.pdf_r.N0_max == pytest.approx(2e11)
        assert sb.pdf_r.xr_min == pytest.approx(6.54e-11)
        assert sb.pdf_r.is_limited is True

    def test_2m_container_route(self):
        mp = TP.microphysics_2m_params_from_overrides(
            TP.calibrated_overrides("SB2006_limiters"))
        assert mp.warm_rain.seifert_beheng.pdf_r.N0_max == pytest.approx(2e11)
        assert mp.ice is None


@pytest.mark.parametrize("name", SETS)
def test_toml_copies_are_byte_identical(name):
    port, ref = TC.calibrated_toml_path(name), JC.calibrated_toml_path(name)
    assert port.parent == Path(TC.__file__).parent / "toml"
    assert port.read_bytes() == ref.read_bytes()
    assert sorted(p.name for p in port.parent.glob("*.toml")) == sorted(
        p.name for p in ref.parent.glob("*.toml"))


def test_name_map_matches():
    assert TC.NAME_MAP == JC.NAME_MAP


@pytest.mark.parametrize("factory", FACTORIES)
@pytest.mark.parametrize("name", SETS)
def test_structs_match_field_by_field(name, factory):
    overrides = JP.calibrated_overrides(name)
    assert TP.calibrated_overrides(name) == overrides
    _assert_same_tree(getattr(TC, factory)(overrides, strict=False),
                      getattr(JC, factory)(overrides, strict=False))


@pytest.mark.parametrize("factory", FACTORIES)
def test_every_mapped_name_matches(factory):
    # every name of NAME_MAP at once, non-default values
    overrides = {n: 0.5 + i / 64 for i, n in enumerate(JC.NAME_MAP)}
    _assert_same_tree(getattr(TC, factory)(overrides),
                      getattr(JC, factory)(overrides))
