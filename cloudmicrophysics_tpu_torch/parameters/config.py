"""Flat-TOML parameter-override pipeline.

Port of ``cloudmicrophysics_tpu/parameters/config.py`` (reference
``src/parameters/Parameters.jl:62-74`` and ``src/parameters/toml/``): a
flat TOML file of ClimaParams-style long names is parsed on the host,
mapped through an explicit name→factory-kwarg table, and routed through
the parameter *factories*, so that derived fields (gamma precomputes,
``m0``/``a0``/``v0``) stay consistent with the overridden raw
coefficients.

Two TOML spellings are accepted, matching the reference's shipped files::

    [rain_autoconversion_timescale]
    value = 13353.89

and the flat form ``rain_autoconversion_timescale = 13353.89``.

The calibrated override sets shipped with the reference (``CliMA_1M.toml``,
``ARG2000.toml``, ``SB2006_limiters.toml``) are this package's own copies
under ``parameters/toml/``, loadable by name via
:func:`calibrated_overrides`. A calibrated 1M block reaches the fused
kernel through ``Microphysics1MParams.terminal_velocity`` and the rest of
the struct, which ``kernels/column1m.kernel_params`` reads; each distinct
block is one more build of the kernel.
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path

from .aerosol import AerosolActivationParameters
from .common import AirProperties
from .m1 import (
    CloudPhaseParams1M,
    Microphysics1MParams,
    PrecipPhaseParams1M,
    cloud_ice,
    microphysics_1m_params,
    rain,
    snow,
)
from .m2 import Microphysics2MParams, microphysics_2m_params, sb2006
from .terminal_velocity import (
    Blk1MVelType,
    blk1m_vel_rain,
    blk1m_vel_snow,
)

__all__ = [
    "load_toml_overrides",
    "calibrated_overrides",
    "calibrated_toml_path",
    "microphysics_1m_params_from_overrides",
    "aerosol_activation_params_from_overrides",
    "sb2006_from_overrides",
    "microphysics_2m_params_from_overrides",
    "NAME_MAP",
]

_TOML_DIR = Path(__file__).parent / "toml"


def load_toml_overrides(source) -> dict[str, float]:
    """Parse a flat override TOML (path, ``Path``, or TOML text).

    Returns ``{long_name: value}``. Both ``[name]\\nvalue = x`` tables and
    flat ``name = x`` pairs are accepted."""
    if isinstance(source, Path) or (
        isinstance(source, str) and "\n" not in source
        and source.endswith(".toml")
    ):
        text = Path(source).read_text()
    else:
        text = source
    raw = tomllib.loads(text)
    out: dict[str, float] = {}
    for name, entry in raw.items():
        if isinstance(entry, dict):
            if "value" not in entry:
                raise ValueError(
                    f"override table [{name}] has no 'value' key")
            out[name] = entry["value"]
        else:
            out[name] = entry
    return out


def calibrated_toml_path(name: str) -> Path:
    """Path to a shipped calibrated override set
    ("CliMA_1M" | "ARG2000" | "SB2006_limiters")."""
    p = _TOML_DIR / f"{name}.toml"
    if not p.exists():
        raise FileNotFoundError(
            f"no shipped override set {name!r}; available: "
            f"{sorted(q.stem for q in _TOML_DIR.glob('*.toml'))}")
    return p


def calibrated_overrides(name: str) -> dict[str, float]:
    return load_toml_overrides(calibrated_toml_path(name))


# ---------------------------------------------------------------------------
# Name map: ClimaParams long name -> (group, factory kwarg)
#
# Groups address the factory whose kwargs do the host-side precompute:
#   rain/snow/cloud_ice        -> parameters.m1 factories
#   vel_rain/vel_snow          -> terminal_velocity blk1m factories
#   acnv_kessler/acnv_var      -> process_params_for option overrides
#   cloud_liquid_formation     -> relaxation tau
#   arg                        -> AerosolActivationParameters fields
#   sb_pdf_r                   -> RainParticlePDF_SB2006 fields
# ---------------------------------------------------------------------------

NAME_MAP: dict[str, tuple[str, str]] = {
    # --- CliMA_1M calibrated set (reference toml/CliMA_1M.toml)
    "condensation_evaporation_timescale": ("cloud_liquid_formation",
                                           "tau_relax"),
    "rain_autoconversion_timescale": ("acnv_kessler", "tau"),
    "Variable_time_scale_autoconversion_coeff_alpha": ("acnv_var", "alpha"),
    "rain_terminal_velocity_size_relation_coefficient_chiv": ("vel_rain",
                                                              "chiv"),
    "rain_terminal_velocity_size_relation_coefficient_delv": ("vel_rain",
                                                              "dv"),
    "rain_cross_section_size_relation_coefficient_chia": ("rain", "chia"),
    "rain_cross_section_size_relation_coefficient_dela": ("rain", "da"),
    "rain_ventilation_coefficient_a": ("rain", "vent_a"),
    "rain_ventilation_coefficient_b": ("rain", "vent_b"),
    # commonly calibrated extras with the same naming convention
    "rain_autoconversion_threshold": ("acnv_kessler", "q_threshold"),
    "snow_autoconversion_timescale": ("acnv_snow", "tau"),
    "snow_autoconversion_threshold": ("acnv_snow", "q_threshold"),
    "rain_drop_size_distribution_coefficient_n0": ("rain", "n0"),
    "snow_apparent_density": ("snow", "rho_i"),
    "cloud_ice_apparent_density": ("cloud_ice", "rho_i"),
    "snow_aspect_ratio": ("snow", "phi"),
    # --- ARG2000 calibrated set (reference toml/ARG2000.toml)
    "ARG2000_f_coeff_1": ("arg", "f1"),
    "ARG2000_f_coeff_2": ("arg", "f2"),
    "ARG2000_g_coeff_1": ("arg", "g1"),
    "ARG2000_g_coeff_2": ("arg", "g2"),
    "ARG2000_pow_1": ("arg", "p1"),
    "ARG2000_pow_2": ("arg", "p2"),
    # --- SB2006 limiter set (reference toml/SB2006_limiters.toml)
    "SB2006_raindrops_min_mass": ("sb_pdf_r", "xr_min"),
    "SB2006_raindrops_max_mass": ("sb_pdf_r", "xr_max"),
    "SB2006_raindrops_size_distribution_coeff_N0_min": ("sb_pdf_r",
                                                        "N0_min"),
    "SB2006_raindrops_size_distribution_coeff_N0_max": ("sb_pdf_r",
                                                        "N0_max"),
    "SB2006_raindrops_size_distribution_coeff_lambda_min": ("sb_pdf_r",
                                                            "lambda_min"),
    "SB2006_raindrops_size_distribution_coeff_lambda_max": ("sb_pdf_r",
                                                            "lambda_max"),
}


def _group_kwargs(overrides: dict[str, float],
                  strict: bool = True) -> dict[str, dict[str, float]]:
    groups: dict[str, dict[str, float]] = {}
    for name, value in overrides.items():
        if name not in NAME_MAP:
            if strict:
                raise KeyError(
                    f"unknown override parameter {name!r}; add it to "
                    "cloudmicrophysics_tpu_torch.parameters.config.NAME_MAP")
            continue
        group, kwarg = NAME_MAP[name]
        groups.setdefault(group, {})[kwarg] = value
    return groups


def microphysics_1m_params_from_overrides(
    overrides: dict[str, float], strict: bool = True, **options_kwargs
) -> Microphysics1MParams:
    """Default 1M parameter set with flat-TOML overrides applied through
    the factories (so gamma precomputes and v0/m0/a0 re-derive)."""
    g = _group_kwargs(overrides, strict)
    process_overrides = {}
    if "cloud_liquid_formation" in g:
        process_overrides["CloudLiquidFormation"] = g[
            "cloud_liquid_formation"]
    if "acnv_kessler" in g:
        process_overrides["Kessler1M"] = g["acnv_kessler"]
    if "acnv_var" in g:
        process_overrides["PrescribedNd"] = g["acnv_var"]
    if "acnv_snow" in g:
        # only the NoSupersaturation (Kessler-type) snow autoconversion has
        # tau/q_threshold; WithSupersaturation has a single r_ice_snow knob
        process_overrides.setdefault("NoSupersaturation", {}).update(
            g["acnv_snow"])
    base = microphysics_1m_params(process_overrides=process_overrides,
                                  **options_kwargs)
    replace = {}
    if "rain" in g or "snow" in g or "cloud_ice" in g:
        replace["precip"] = PrecipPhaseParams1M(
            rain=rain(**g.get("rain", {})), snow=snow(**g.get("snow", {})))
        replace["cloud"] = CloudPhaseParams1M(
            liquid=base.cloud.liquid, ice=cloud_ice(**g.get("cloud_ice", {})))
    if "vel_rain" in g or "vel_snow" in g:
        replace["terminal_velocity"] = Blk1MVelType(
            rain=blk1m_vel_rain(**g.get("vel_rain", {})),
            snow=blk1m_vel_snow(**g.get("vel_snow", {})))
    return dataclasses.replace(base, **replace) if replace else base


def aerosol_activation_params_from_overrides(
    overrides: dict[str, float], strict: bool = True,
) -> AerosolActivationParameters:
    g = _group_kwargs(overrides, strict)
    return AerosolActivationParameters(**g.get("arg", {}))


def sb2006_from_overrides(overrides: dict[str, float],
                          is_limited: bool = True, strict: bool = True):
    g = _group_kwargs(overrides, strict)
    return sb2006(is_limited=is_limited, pdf_r=g.get("sb_pdf_r", {}))


def microphysics_2m_params_from_overrides(
    overrides: dict[str, float], strict: bool = True, **kwargs
) -> Microphysics2MParams:
    base = microphysics_2m_params(**kwargs)
    sb = sb2006_from_overrides(overrides, strict=strict)
    return dataclasses.replace(
        base, warm_rain=dataclasses.replace(base.warm_rain,
                                            seifert_beheng=sb))
