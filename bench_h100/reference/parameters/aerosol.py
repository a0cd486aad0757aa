"""Aerosol model and ARG2000 activation parameters, frozen for the
benchmark.

A copy of the program's ``parameters/aerosol.py`` (reference
``src/AerosolModel.jl``: lognormal modes with B- or kappa-based chemistry,
and ``src/parameters/AerosolActivation.jl``: the ARG2000 fit constants):
the same classes, fields and defaults. A numeric field may also hold a
tensor, one value per point of the state it broadcasts against.
"""

from __future__ import annotations

from typing import Tuple

from ..utils.param import paramclass


@paramclass
class ModeB:
    """Lognormal aerosol mode, Abdul-Razzak & Ghan 2000 chemistry
    (reference src/AerosolModel.jl:26-49). Per-component values are tuples.
    """

    r_dry: float            # geometric mean dry radius [m]
    stdev: float            # geometric standard deviation
    N: float                # total number concentration [1/m^3]
    mass_mix_ratio: Tuple[float, ...]
    soluble_mass_frac: Tuple[float, ...]
    osmotic_coeff: Tuple[float, ...]
    molar_mass: Tuple[float, ...]
    dissoc: Tuple[float, ...]
    aerosol_density: Tuple[float, ...]


@paramclass
class ModeKappa:
    """Lognormal aerosol mode, Petters & Kreidenweis 2007 kappa-Koehler
    chemistry (reference src/AerosolModel.jl:52-80)."""

    r_dry: float
    stdev: float
    N: float
    vol_mix_ratio: Tuple[float, ...]
    mass_mix_ratio: Tuple[float, ...]
    molar_mass: Tuple[float, ...]
    kappa: Tuple[float, ...]


@paramclass
class AerosolDistribution:
    """Tuple of modes, static mode count
    (reference src/AerosolModel.jl:83-103)."""

    modes: tuple

    @property
    def n_modes(self) -> int:
        return len(self.modes)


@paramclass
class AerosolActivationParameters:
    """ARG2000 activation constants
    (reference src/parameters/AerosolActivation.jl:12-58). The f/g/p values
    are the published Abdul-Razzak & Ghan 2000 fit; calibrated ARG2000.toml
    overrides exist in the reference repo."""

    M_w: float = 0.01801528  # molar mass of water [kg/mol]
    R: float = 8.3144598     # universal gas constant [J/mol/K]
    rho_w: float = 1000.0    # water density [kg/m^3]
    rho_i: float = 916.7     # ice density [kg/m^3]
    sigma: float = 0.072     # surface tension of water [N/m]
    g: float = 9.81          # gravitational acceleration [m/s^2]
    f1: float = 0.5
    f2: float = 2.5
    g1: float = 1.0
    g2: float = 0.25
    p1: float = 1.5
    p2: float = 0.75
