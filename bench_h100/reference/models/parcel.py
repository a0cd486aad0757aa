"""The adiabatic parcel's Euler step, frozen here for the parcel cell: the
ten prognostics ``[S_l, p, T, q_vap, q_liq, q_ice, N_aer, N_liq, N_ice,
ln_INPC]`` (reference ``parcel/ParcelModel.jl``) with only the processes
that cell runs: Mohler 2006 deposition nucleation on dust by activated
fraction (``MohlerAF``), deposition growth of monodisperse ice, and the
adiabatic ascent at each member's updraft. The other processes contribute
nothing there (no liquid, no activation, immersion, homogeneous freezing
or condensation), so their zero rates are left out of the sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..ops import thermo as TDI
from ..parameters.aerosol_species import DesertDust
from ..parameters.common import AirProperties, WaterProperties
from ..parameters.ice_nucleation import Mohler2006
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import float_dtype, floatmin

PI = math.pi


class ParcelState(NamedTuple):
    """Parcel prognostics, all base SI (reference parcel/ParcelModel.jl)."""

    S_l: torch.Tensor
    p_air: torch.Tensor
    T: torch.Tensor
    q_vap: torch.Tensor
    q_liq: torch.Tensor
    q_ice: torch.Tensor
    N_aer: torch.Tensor
    N_liq: torch.Tensor
    N_ice: torch.Tensor
    ln_inpc: torch.Tensor


class Constants(NamedTuple):
    """What the step reads besides the state and the updraft."""

    dt: float
    r_nuc: float
    dust: DesertDust
    mohler: Mohler2006
    tps: ThermodynamicsParameters
    aps: AirProperties
    wps: WaterProperties


def constants(dt: float, r_nuc: float) -> Constants:
    """The defaults of every parameter set, the time step ``dt`` and the
    nucleated crystals' radius ``r_nuc``."""
    return Constants(float(dt), float(r_nuc), DesertDust(), Mohler2006(),
                     ThermodynamicsParameters(), AirProperties(),
                     WaterProperties())


def _clip(x):
    return torch.clamp(x, min=0.0)


def _monodisperse(q, N, rho, rho_air):
    """Mean radius and volume of a monodisperse population (reference
    parcel/ParcelDistributions.jl)."""
    tiny = floatmin(float_dtype(q, N))
    empty = (N <= 0) | (q <= 0)
    N_s = torch.clamp(N, min=tiny)
    q_s = torch.clamp(q, min=tiny)
    r = (q_s / N_s / (4 / 3 * PI) / rho * rho_air) ** (1 / 3)
    z = torch.zeros_like(r)
    return torch.where(empty, z, r)


def _limited_growth(raw, q_vap, q_cond, dt):
    return torch.where(
        raw > 0,
        torch.minimum(raw, q_vap / dt),
        -torch.minimum(torch.abs(raw), q_cond / dt))


def step(y: ParcelState, w: torch.Tensor, c: Constants) -> ParcelState:
    """One Euler step of ``c.dt`` of every member of ``y`` (fields of one
    shape, and ``w``, the members' updrafts [m/s], of the same)."""
    tps, aps, wps = c.tps, c.aps, c.wps
    tiny = floatmin(float_dtype(y.T))
    S_l, p_air, T = y.S_l, y.p_air, y.T
    q_vap, q_liq, q_ice = _clip(y.q_vap), _clip(y.q_liq), _clip(y.q_ice)
    N_aer, N_ice = _clip(y.N_aer), _clip(y.N_ice)

    Rv = tps.R_v
    q_tot = q_vap + q_liq + q_ice
    R_air = TDI.gas_constant_air(tps, q_tot, q_liq, q_ice)
    cp_air = TDI.cp_m(tps, q_tot, q_liq, q_ice)
    L_subl = TDI.latent_heat_sublim(tps, T)
    L_vap = TDI.latent_heat_vapor(tps, T)
    rho_air = TDI.air_density(tps, T, p_air, q_tot, q_liq, q_ice)
    e = q_vap * p_air * Rv / R_air
    e_sl = TDI.saturation_vapor_pressure_over_liquid(tps, T)
    r_ice = _monodisperse(q_ice, N_ice, wps.rho_i, rho_air)
    zero = torch.zeros_like(T)

    # deposition nucleation: the dust's activated fraction (MohlerAF)
    S_i = (TDI.saturation_vapor_pressure_over_liquid(tps, T)
           / TDI.saturation_vapor_pressure_over_ice(tps, T)) * S_l
    AF = CMI.dust_activated_number_fraction(c.dust, c.mohler, S_i, T)
    AF = torch.where(S_i >= c.mohler.Si_max, zero, AF)
    dN_ice_dep = _clip(AF * N_aer - N_ice) / c.dt
    dq_ice_dep = (dN_ice_dep * 4 / 3 * PI * c.r_nuc**3 * wps.rho_i
                  / rho_air)

    # deposition growth of the monodisperse ice
    G_i = CMO.G_func_ice(aps, tps, T)
    raw = 4 * PI / rho_air * (S_i - 1) * G_i * r_ice * N_ice
    dq_ice_ds = _limited_growth(raw, q_vap, q_ice, c.dt)
    dN_ice_ds = torch.where(
        (dq_ice_ds < 0) & (q_ice > 0) & (q_ice < 1e-6),
        N_ice * dq_ice_ds / torch.clamp(q_ice, min=tiny), zero)

    # budgets and the adiabatic ascent
    dN_ice = dN_ice_dep + dN_ice_ds
    dN_aer = -dN_ice_dep
    dq_ice_v2i = dq_ice_dep + dq_ice_ds
    dq_vap = -dq_ice_v2i
    grav = tps.grav
    dp_air = -p_air * grav / R_air / T * w
    dT = -grav / cp_air * w + L_subl / cp_air * dq_ice_v2i
    de = dq_vap * p_air * Rv / R_air + q_vap * dp_air * Rv / R_air
    de_sl = L_vap * e_sl / Rv / T**2 * dT
    dS_l = 1 / e_sl * de - e / e_sl**2 * de_sl

    dy = ParcelState(dS_l, dp_air, dT, dq_vap, zero, dq_ice_v2i, dN_aer,
                     zero, dN_ice, zero)
    return ParcelState(*(v + c.dt * d for v, d in zip(y, dy)))
