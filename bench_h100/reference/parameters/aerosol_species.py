"""Aerosol species constants (Mohler 2006 Table 2, Knopf and Alpert 2013):
the desert dust of the parcel cell, frozen here."""

from __future__ import annotations

from ..utils.param import paramclass


@paramclass
class DesertDust:
    """Saharan desert dust (Mohler 2006 Table 2 + Knopf-Alpert 2013)."""

    S0_warm: float = 1.2
    S0_cold: float = 1.05
    a_warm: float = 2.0
    a_cold: float = 4.7
    deposition_m: float = 5.8
    deposition_c: float = 0.91
    ABIFM_m: float = 22.62
    ABIFM_c: float = -1.35
