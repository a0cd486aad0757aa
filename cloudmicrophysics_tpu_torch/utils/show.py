"""Human-readable parameter-struct display.

Port of ``cloudmicrophysics_tpu/utils/show.py`` (reference ``src/show.jl``):
verbose / compact / parseable rendering of nested parameter dataclasses,
with optional unit annotations. For the same struct the output is the same
string as the JAX package's. Diagnostics-as-physics (reflectivity,
effective radius) live in ``ops.diagnostics``; this module is the
struct-display subsystem.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["show_params", "field_units"]

# Unit annotations by (class name, field name), the JAX package's table:
# every struct the reference annotates (its ``ShowMethods.field_units``:
# AirProperties.jl:20, Microphysics1M.jl:55,78,143,176,
# MicrophysicsP3.jl:326-331, P3_particle_properties.jl:60-62) plus the
# other major containers.
FIELD_UNITS = {
    ("AirProperties", "K_therm"): "W/m/K",
    ("AirProperties", "D_vapor"): "m^2/s",
    ("AirProperties", "nu_air"): "m^2/s",
    ("WaterProperties", "rho_w"): "kg/m^3",
    ("WaterProperties", "rho_i"): "kg/m^3",
    ("Parameters0M", "tau_precip"): "s",
    ("Parameters0M", "qc_0"): "kg/kg",
    ("ParticleMass", "r0"): "m",
    ("ParticleMass", "m0"): "kg",
    ("ParticleArea", "a0"): "m^2",
    ("CloudLiquid", "rho_w"): "kg/m^3",
    ("CloudLiquid", "r_eff"): "m",
    ("CloudLiquid", "N_0"): "1/m^3",
    ("CloudIce", "rho_i"): "kg/m^3",
    ("CloudIce", "r_eff"): "m",
    ("CloudIce", "N_0"): "1/m^3",
    ("Rain", "rho_w"): "kg/m^3",
    ("Snow", "rho_i"): "kg/m^3",
    ("Snow", "T_freeze"): "K",
    ("Acnv1M", "tau"): "s",
    ("Acnv1M", "q_threshold"): "kg/kg",
    ("ThermodynamicsParameters", "T_freeze"): "K",
    ("ThermodynamicsParameters", "LH_v0"): "J/kg",
    ("ThermodynamicsParameters", "LH_s0"): "J/kg",
    ("ThermodynamicsParameters", "cp_l"): "J/kg/K",
    ("ThermodynamicsParameters", "cp_v"): "J/kg/K",
    ("ThermodynamicsParameters", "R_v"): "J/kg/K",
    ("ThermodynamicsParameters", "R_d"): "J/kg/K",
    # P3 (reference MicrophysicsP3.jl:326-331)
    ("ParametersP3", "tau_wet"): "s",
    ("ParametersP3", "rho_i"): "kg/m^3",
    ("ParametersP3", "rho_l"): "kg/m^3",
    ("ParametersP3", "T_freeze"): "K",
    ("MassPowerLaw", "alpha_va"): "kg m^(-beta_va)",
    ("AreaPowerLaw", "gamma"): "um^(2-sigma)",
    ("SlopePowerLaw", "a"): "m^b",
    ("LocalRimeDensity", "rho_ice"): "kg/m^3",
    # P3State (reference P3_particle_properties.jl:60-62)
    ("P3State", "rho_q_ice"): "kg/m^3",
    ("P3State", "rho_n_ice"): "1/m^3",
    ("P3State", "rho_rim"): "kg/m^3",
    ("P3State", "rho_g"): "kg/m^3",
    ("P3State", "D_th"): "m",
    ("P3State", "D_gr"): "m",
    ("P3State", "D_cr"): "m",
    # 2M SB2006
    ("RainParticlePDF_SB2006", "xr_min"): "kg",
    ("RainParticlePDF_SB2006", "xr_max"): "kg",
    ("RainParticlePDF_SB2006", "N0_min"): "1/m^4",
    ("RainParticlePDF_SB2006", "N0_max"): "1/m^4",
    ("RainParticlePDF_SB2006", "lambda_min"): "1/m",
    ("RainParticlePDF_SB2006", "lambda_max"): "1/m",
    ("RainParticlePDF_SB2006", "rho_w"): "kg/m^3",
    ("CloudParticlePDF_SB2006", "rho_w"): "kg/m^3",
    ("AcnvSB2006", "x_star"): "kg",
    ("IceNumberAdjustment", "x_min"): "kg",
    ("IceNumberAdjustment", "x_max"): "kg",
    ("IceNumberAdjustment", "tau"): "s",
    # ice nucleation
    ("Mohler2006", "T_thr"): "K",
    ("Frostenberg2023", "sigma"): "log(1/m^3)",
    ("NIceProxyDepletion", "tau_act"): "s",
    # aerosol / activation
    ("ModeB", "r_dry"): "m",
    ("ModeB", "N"): "1/m^3",
    ("ModeKappa", "r_dry"): "m",
    ("ModeKappa", "N"): "1/m^3",
    ("H2SO4SolutionParameters", "T_max"): "K",
    ("H2SO4SolutionParameters", "T_min"): "K",
}


def field_units(obj: Any, name: str) -> str:
    return FIELD_UNITS.get((type(obj).__name__, name), "")


def show_params(obj: Any, mode: str = "verbose", indent: int = 0) -> str:
    """Render a paramclass tree.

    ``mode``:
    * ``"verbose"`` — nested multi-line with units;
    * ``"compact"`` — single line ``Type(field=value, ...)``;
    * ``"parseable"`` — Python-constructor form that round-trips.
    """
    if not dataclasses.is_dataclass(obj):
        return repr(obj)

    cls = type(obj).__name__
    fields = dataclasses.fields(obj)

    if mode == "compact":
        inner = ", ".join(
            f"{f.name}={_compact_value(getattr(obj, f.name))}"
            for f in fields)
        return f"{cls}({inner})"

    if mode == "parseable":
        inner = ", ".join(
            f"{f.name}={show_params(getattr(obj, f.name), 'parseable')}"
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else f"{f.name}={getattr(obj, f.name)!r}"
            for f in fields)
        return f"{cls}({inner})"

    # verbose
    pad = "  " * indent
    lines = [f"{pad}{cls}:"]
    for f in fields:
        v = getattr(obj, f.name)
        unit = field_units(obj, f.name)
        unit_s = f" [{unit}]" if unit else ""
        if dataclasses.is_dataclass(v):
            lines.append(f"{pad}  {f.name}:")
            lines.append(show_params(v, "verbose", indent + 2))
        else:
            lines.append(f"{pad}  {f.name} = {_compact_value(v)}{unit_s}")
    return "\n".join(lines)


def _compact_value(v: Any) -> str:
    if dataclasses.is_dataclass(v):
        return f"{type(v).__name__}(...)"
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, tuple) and len(v) > 4:
        return f"({v[0]:g}, ..., {v[-1]:g})<{len(v)}>"
    return repr(v)
