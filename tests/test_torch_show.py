"""The port's parameter-struct display against the JAX package, on the
CPU: every case of ``tests/test_show.py`` on the port, and the same
string as the JAX package's ``show_params`` in all three modes for the
same structs."""

import pytest

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.utils import show as JS
from cloudmicrophysics_tpu_torch.parameters import Parameters0M
from cloudmicrophysics_tpu_torch.utils import field_units, show_params

MODES = ("verbose", "compact", "parseable")


class TestShow:
    def test_verbose_has_units(self):
        out = show_params(TP.AirProperties(), "verbose")
        assert "AirProperties:" in out
        assert "[W/m/K]" in out and "[m^2/s]" in out

    def test_compact_single_line(self):
        out = show_params(Parameters0M(), "compact")
        assert "\n" not in out
        assert out.startswith("Parameters0M(")
        assert "tau_precip=1000" in out

    def test_parseable_roundtrips(self):
        p = Parameters0M()
        assert eval(show_params(p, "parseable"),
                    {"Parameters0M": Parameters0M}) == p

    def test_nested_tree(self):
        out = show_params(TP.microphysics_1m_params(), "verbose")
        assert "Rain" in out and "Snow" in out
        assert "  " in out

    def test_field_units_lookup(self):
        assert field_units(TP.AirProperties(), "K_therm") == "W/m/K"
        assert field_units(TP.AirProperties(), "no_such_field") == ""

    def test_non_dataclass_is_repr(self):
        assert show_params(1.5) == repr(1.5) == JS.show_params(1.5)


def _structs(pkg):
    P = pkg
    cal = P.calibrated_overrides
    return {
        "AirProperties": P.AirProperties(),
        "Parameters0M": P.Parameters0M(),
        "ThermodynamicsParameters": P.ThermodynamicsParameters(),
        "microphysics_0m_params": P.microphysics_0m_params(),
        "microphysics_1m_params": P.microphysics_1m_params(),
        "microphysics_2m_params": P.microphysics_2m_params(),
        "terminal_velocity_params": P.terminal_velocity_params(),
        "CliMA_1M": P.microphysics_1m_params_from_overrides(cal("CliMA_1M")),
        "ARG2000": P.aerosol_activation_params_from_overrides(
            cal("ARG2000")),
        "SB2006_limiters": P.microphysics_2m_params_from_overrides(
            cal("SB2006_limiters")),
    }


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(_structs(JP)))
def test_same_string_as_the_jax_package(name, mode):
    port, ref = _structs(TP)[name], _structs(JP)[name]
    assert show_params(port, mode) == JS.show_params(ref, mode)


def test_units_table_matches():
    from cloudmicrophysics_tpu_torch.utils import show as TS

    assert TS.FIELD_UNITS == JS.FIELD_UNITS
