"""P3 microphysical processes: melting, liquid-ice collisions, and ice
self-collection.

Port of ``cloudmicrophysics_tpu/ops/p3_processes.py`` (reference
``src/P3_processes.jl``), the parts the 2M+P3 column step runs:

* :func:`ice_melt` — ventilation melt integral (``:64-94``);
* :func:`bulk_liquid_ice_collision_sources` — the nested (ice node x
  liquid node) collision integral with the Musil freezing/shedding split
  and wet growth, with the default ``rain_inner="quadrature"``
  (``:152-655``);
* :func:`ice_self_collection` — the segment-blocked double integral, the
  default ``inner="blocked"`` (``:676-712``).

Not ported yet: ``rain_inner="quadrature_split"`` and ``"closed_form"``,
``inner="triangle"`` and ``het_ice_nucleation``.

Every sum over a node axis (liquid nodes, ice nodes, self-collection inner
nodes) runs one node at a time in node order
(:func:`..utils.quadrature.sum_nodes`), so a kernel that visits the nodes in
the same order adds them alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parameters.common import AirProperties
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.quadrature import (
    GaussLegendre,
    QuadratureRule,
    default_quadrature,
    sum_nodes,
)
from ..utils.quadrature import nodes as _nodes
from ..utils.special import clamp_to_nonneg, float_dtype, floatmin, machine_eps
from . import common as CO
from . import m2 as CM2
from . import p3 as P3
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = math.pi

__all__ = [
    "CollisionSources",
    "bulk_liquid_ice_collision_sources",
    "collision_cross_section_coeffs",
    "compute_local_rime_density",
    "compute_max_freeze_rate",
    "ice_melt",
    "ice_self_collection",
]


def _node_iter(quad: QuadratureRule, a, b):
    """Yield ``(x_j, w_j)`` per quadrature node without materializing the
    ``(n, *shape)`` node tensor: inner integrals accumulate node by node.
    Invalid (``a >= b``) windows get zero weights on the dead-branch
    window ``[1, 2]``."""
    y_np, w_np = quad.nodes_weights()
    valid = a < b
    a_s = torch.where(valid, a, torch.ones_like(a))
    b_s = torch.where(valid, b, 2 * torch.ones_like(b))
    scale = (b_s - a_s) / 2
    mid = (a_s + b_s) / 2
    zero = torch.zeros_like(scale)
    for yj, wj in zip(y_np.reshape(-1).tolist(), w_np.reshape(-1).tolist()):
        yield scale * yj + mid, torch.where(valid, wj * scale, zero)


# ---------------------------------------------------------------------------
# Melting (reference src/P3_processes.jl:64-94)
# ---------------------------------------------------------------------------

def ice_melt(velocity_params, aps: AirProperties, tps: TPS, T_a, rho_a,
             state: P3.P3State, loglambda, quad=None, nodes=None):
    """Ventilation-integral melt rate (QIMLT). Returns (dNdt, dLdt).

    Pass ``nodes`` (a step-shared :class:`P3.IceQuadNodes`) to reuse the
    bounds/velocity/PSD node tables; ``quad`` is then ignored."""
    if quad is None:
        quad = default_quadrature()
    dt = float_dtype(T_a, rho_a)
    L_f = TDI.latent_heat_fusion(tps, T_a)
    T_freeze = state.params.T_freeze
    vent = state.params.vent

    if nodes is None:
        nodes = P3.ice_quadrature_nodes(velocity_params, rho_a, state,
                                        loglambda, 1e-6, quad)
    x = nodes.D

    F_v = CO.ventilation_factor(vent, aps, nodes.v, x)
    integrand = P3.d_ice_mass_dD(state, x) * F_v * nodes.nw / x
    fac = 4 * aps.K_therm / L_f * (T_a - T_freeze)
    dLdt_raw = fac * sum_nodes(integrand)

    dLdt = clamp_to_nonneg(dLdt_raw)  # only melting, not fusion
    q_safe = torch.clamp(state.rho_q_ice, min=floatmin(dt))
    dNdt = state.rho_n_ice / q_safe * dLdt
    return dNdt, dLdt


# ---------------------------------------------------------------------------
# Collision machinery (reference src/P3_processes.jl:112-279)
# ---------------------------------------------------------------------------

def collision_cross_section_coeffs(state, D_i):
    """(k0, k1, k2) of ``sigma(D_i, D_l) = k0 + k1 D_l + k2 D_l^2``."""
    r_i = torch.sqrt(P3.ice_area(state, D_i) / PI)
    return PI * r_i**2, PI * r_i, PI / 4


def compute_max_freeze_rate(aps: AirProperties, tps: TPS, velocity_params,
                            rho_a, T_a, state):
    """Musil 1970 dry-growth thermodynamic freezing limit; returns a
    function of D_i (reference src/P3_processes.jl:184-219)."""
    dt = float_dtype(rho_a, T_a)
    cp_l = tps.cp_l
    T_frz = tps.T_freeze
    Lv = TDI.latent_heat_vapor(tps, T_a)
    L_f = TDI.latent_heat_fusion(tps, T_a)
    dT = T_frz - T_a
    # the saturation vapor pressure at freezing is a Python float, folded on
    # the host in float64
    p_sat_frz = float(TDI.saturation_vapor_pressure_over_ice(
        tps, torch.tensor(T_frz, dtype=torch.float64)))
    drho_v_sat = rho_a * (
        TDI.p2q(tps, T_frz, rho_a, p_sat_frz)
        - TDI.p2q(tps, T_a, rho_a,
                  TDI.saturation_vapor_pressure_over_ice(tps, T_a)))
    denom = L_f - cp_l * dT
    big = torch.finfo(dt).max

    def max_freeze_rate(D_i, v_at_D=None):
        # v_at_D: optional precomputed terminal velocity at D_i (the shared
        # IceQuadNodes table)
        v = v_at_D
        if v is None:
            v = P3.ice_particle_terminal_velocity(velocity_params, rho_a,
                                                  state)(D_i)
        F_v = CO.ventilation_factor(state.params.vent, aps, v, D_i)
        denom_safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        rate = 2 * (PI * D_i) * F_v \
            * (aps.K_therm * dT + Lv * aps.D_vapor * drho_v_sat) / denom_safe
        rate = torch.where(denom > 0, rate, torch.full_like(rate, big))
        return torch.where(T_a >= T_frz, torch.zeros_like(rate), rate)

    return max_freeze_rate


def compute_local_rime_density(velocity_params, rho_a, T, state):
    """Cober & List 1993 local rime density as a function of (D_i, D_l)
    (reference src/P3_processes.jl:266-279)."""
    T_c = T - state.params.T_freeze
    T_c_safe = torch.where(torch.abs(T_c) > 0, T_c,
                           torch.full_like(T_c, -machine_eps(T.dtype)))
    # reciprocal taken once per cell: Ri is evaluated on the whole
    # (liquid x ice x cell) pair space
    inv_2Tc = 1e6 / (2 * T_c_safe)

    def rho_rim_local(D_i, D_l, v_i_at=None, v_rel=None):
        # v_i_at: optional precomputed ice velocity at D_i; v_rel: optional
        # precomputed |v_ice(D_i) - v_liq(D_l)| (skips both velocities)
        if v_rel is None:
            aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(velocity_params.rain,
                                                       rho_a)
            v_liq = CO.chen2022_velocity_sum(aiu, bi, ciu, D_l)
            if v_i_at is None:
                v_i_at = P3.ice_particle_terminal_velocity(
                    velocity_params, rho_a, state)(D_i)
            v_rel = torch.abs(v_i_at - v_liq)
        Ri = D_l * v_rel * inv_2Tc
        return state.params.rho_rim_local(Ri)

    return rho_rim_local


# ---------------------------------------------------------------------------
# The 2-D liquid-ice collision integral
# (reference src/P3_processes.jl:283-567)
# ---------------------------------------------------------------------------

class CollisionSources(NamedTuple):
    """Bulk tendencies from liquid-ice collisions
    (reference src/P3_processes.jl:606-655)."""

    dq_c: torch.Tensor      # cloud mass tendency [kg/kg/s]
    dq_r: torch.Tensor      # rain mass tendency [kg/kg/s]
    dN_c: torch.Tensor      # cloud number tendency [1/m^3/s]
    dN_r: torch.Tensor      # rain number tendency [1/m^3/s]
    dL_rim: torch.Tensor    # rime mass tendency [kg/m^3/s]
    dL_ice: torch.Tensor    # ice mass tendency [kg/m^3/s]
    dB_rim: torch.Tensor    # rime volume tendency [m^3/m^3/s]


def liquid_quadrature(quad: QuadratureRule) -> QuadratureRule:
    """The liquid (inner) axis rule of the collision integral: half the ice
    order with a floor of 8 (Gauss-Legendre) when the ice order exceeds 8,
    the ice rule itself otherwise. The reference's docstring says the
    anchor modes keep the full order, but the code halves the axis before
    the mode branch (``p3_processes.py:363-364``); this follows the code."""
    return GaussLegendre(max(quad.n // 2, 8)) if quad.n > 8 else quad


def bulk_liquid_ice_collision_sources(
    state: P3.P3State, loglambda, pdf_c, pdf_r, L_c, N_c, L_r, N_r,
    aps: AirProperties, tps: TPS, vel, rho_a, T, quad=None,
    rain_inner: str = "quadrature", ice_nodes=None,
) -> CollisionSources:
    """Bulk rates from ice-liquid collisions: nested quadrature over
    (ice nodes x liquid nodes) with the Musil freezing/shedding split and
    wet-growth densification (reference src/P3_processes.jl:533-655).

    The cloud and rain inner integrals use Gauss nodes over the per-cell
    liquid PSD window (``rain_inner="quadrature"``, the JAX package's
    default): every liquid-node factor (Chen 2022 rain velocity, PSD, drop
    mass) is evaluated once per liquid node and broadcast across the ice
    axis. The ``|v_i - v_l|`` kink is integrated through un-split.
    """
    if rain_inner != "quadrature":
        raise NotImplementedError(
            f"rain_inner={rain_inner!r} is not ported; only 'quadrature'")
    if quad is None:
        quad = default_quadrature()
    liquid_quad = liquid_quadrature(quad)
    dt = float_dtype(rho_a, T)
    tau_wet = state.params.tau_wet
    rho_i = state.params.rho_i
    D_shd = 1e-3  # shed drop size [m] (reference TODO)
    rho_w = pdf_c.rho_w

    def m_liq(D):
        return rho_w * CO.volume_sphere_D(D)

    def n_c(D):
        return CM2.size_distribution_cloud(pdf_c, L_c / rho_a, rho_a, N_c, D)

    # one tail quantile for every entry point (the shared IceQuadNodes
    # context also pins 1e-6)
    p = 1e-6
    c_lo, c_hi = CM2.size_distribution_bounds_cloud(pdf_c, L_c / rho_a,
                                                    rho_a, N_c, p)
    r_lo, r_hi = CM2.size_distribution_bounds_rain(pdf_r, L_r / rho_a,
                                                   rho_a, N_r, p)

    aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(vel.rain, rho_a)

    def v_liq(D):
        return CO.chen2022_velocity_sum(aiu, bi, ciu, D)

    rho_rim_loc = compute_local_rime_density(vel, rho_a, T, state)
    max_frz = compute_max_freeze_rate(aps, tps, vel, rho_a, T, state)

    # --- outer ice nodes: (n_i_nodes, *cell) ---
    if ice_nodes is None:
        ice_nodes = P3.ice_quadrature_nodes(vel, rho_a, state, loglambda,
                                            p, quad)
    Di = ice_nodes.D
    v_i_at_Di = ice_nodes.v
    k0, k1, k2 = collision_cross_section_coeffs(state, Di)

    # --- cloud inner integral by quadrature, liquid axis leading ---
    Dl_c, wl_c = _nodes(liquid_quad, c_lo, c_hi)   # (n_l, *cell)
    Dl = Dl_c[:, None]                              # (n_l, 1, *cell)
    # quadrature weight and mass folded into the per-node factors
    nw_c = (n_c(Dl_c) * wl_c)[:, None]
    nwm_c = nw_c * m_liq(Dl)
    K = (k2 * Dl + k1[None]) * Dl + k0[None]
    v_rel_c = torch.abs(v_i_at_Di[None] - v_liq(Dl_c)[:, None])
    dV = K * v_rel_c  # E = 1
    t1 = dV * nw_c
    t2 = dV * nwm_c
    t3 = t2 / rho_rim_loc(Di[None], Dl, v_rel=v_rel_c)
    dN_c_col = sum_nodes(t1)                       # per ice node
    dM_c_col = sum_nodes(t2)
    dB_c_col = sum_nodes(t3)

    # --- rain inner integral ---
    rain_params = CM2.pdf_rain_parameters(pdf_r, L_r / rho_a, rho_a, N_r)
    N0r = rain_params.N0r
    rain_valid = (N0r > 0) & (r_hi > r_lo)
    r_lo_s = torch.where(rain_valid, r_lo, torch.ones_like(r_lo))
    r_hi_s = torch.where(rain_valid, r_hi, 2 * torch.ones_like(r_hi))

    def n_r(D):
        return CM2.size_distribution_rain(pdf_r, L_r / rho_a, rho_a, N_r, D)

    # per-cell fixed nodes: every liquid-node factor once on (n_l, *cell),
    # broadcast across the ice axis; invalid rain windows integrate over
    # the dummy [1, 2] m window, where n_r underflows to 0, and are masked
    # below anyway
    Dl_r, wl_r = _nodes(liquid_quad, r_lo_s, r_hi_s)  # (n_l, *cell)
    v_l = v_liq(Dl_r)
    nw_r = (n_r(Dl_r) * wl_r)[:, None]
    nwm_r = nw_r * m_liq(Dl_r)[:, None]
    Dlr = Dl_r[:, None]
    K_n = (k2 * Dlr + k1[None]) * Dlr + k0[None]
    v_rel = torch.abs(v_i_at_Di[None] - v_l[:, None])
    dV_r = K_n * v_rel
    t2 = dV_r * nwm_r
    t3 = t2 / rho_rim_loc(Di[None], Dlr, v_rel=v_rel)
    dN_r_col = sum_nodes(dV_r * nw_r)
    dM_r_col = sum_nodes(t2)
    dB_r_col = sum_nodes(t3)

    bad = ~(torch.isfinite(dN_r_col) & torch.isfinite(dM_r_col)) \
        | ~rain_valid
    dN_r_col = torch.where(bad, torch.zeros_like(dN_r_col), dN_r_col)
    dM_r_col = torch.where(bad, torch.zeros_like(dM_r_col), dM_r_col)
    dB_r_col = torch.where(bad, torch.zeros_like(dB_r_col), dB_r_col)

    # --- outer assembly: freezing/shedding split per ice node ---
    dM_col = dM_c_col + dM_r_col
    dM_frz = torch.minimum(dM_col, max_frz(Di, v_i_at_Di))
    zero_col = dM_col == 0
    dM_col_safe = torch.where(zero_col, torch.ones_like(dM_col), dM_col)
    f_frz = torch.where(zero_col, torch.zeros_like(dM_col),
                        dM_frz / dM_col_safe)
    wet = (dM_col > dM_frz).to(dt)

    niwi = ice_nodes.nw

    def contract(v):
        return sum_nodes(niwi * v)

    QCFRZ = contract(dM_c_col * f_frz)
    QCSHD = contract(dM_c_col * (1 - f_frz))
    NCCOL = contract(dN_c_col)
    QRFRZ = contract(dM_r_col * f_frz)
    QRSHD = contract(dM_r_col * (1 - f_frz))
    NRCOL = contract(dN_r_col)
    int_M_col = contract(dM_col)
    BCCOL = contract(dB_c_col * f_frz)
    BRCOL = contract(dB_r_col * f_frz)
    int_wet_M_col = contract(wet * dM_col)

    # --- bulk sources (reference :606-655) ---
    zero_int = int_M_col == 0
    M_safe = torch.where(zero_int, torch.ones_like(int_M_col), int_M_col)
    f_wet = torch.where(zero_int, torch.zeros_like(int_M_col),
                        int_wet_M_col / M_safe)
    # shed drop mass, a Python float (the division multiplies by its
    # float64 reciprocal, as every division by a parameter here)
    NRSHD = QRSHD / (rho_w * (D_shd**3 * PI / 6))

    F_rim, rho_rim = state.F_rim, state.rho_rim
    has_rim = rho_rim > 0
    rho_rim_safe = torch.where(has_rim, rho_rim, torch.ones_like(rho_rim))
    B_rim = torch.where(has_rim, state.rho_q_ice * F_rim / rho_rim_safe,
                        torch.zeros_like(rho_rim))
    QIWET = f_wet * state.rho_q_ice * (1 - F_rim) / tau_wet
    BIWET = f_wet * (state.rho_q_ice / rho_i - B_rim) / tau_wet

    return CollisionSources(
        dq_c=(-QCFRZ - QCSHD) / rho_a,
        dq_r=(-QRFRZ + QCSHD) / rho_a,
        dN_c=-NCCOL,
        dN_r=-NRCOL + NRSHD,
        dL_rim=QCFRZ + QRFRZ + QIWET,
        dL_ice=QCFRZ + QRFRZ,
        dB_rim=BCCOL + BRCOL + BIWET,
    )


# ---------------------------------------------------------------------------
# Ice self-collection (reference src/P3_processes.jl:676-712)
# ---------------------------------------------------------------------------

def self_collection_inner_orders(n: int, n_seg: int = 4):
    """Gauss-Legendre orders of the within-segment triangles: a quarter of
    the ice order with a floor of 4, and a floor of 6 on the tail segment,
    which carries the aggregate mass over the longest span
    (``p3_processes.py:702``)."""
    return tuple(max(n // 4, 6) if s == n_seg - 1 else max(n // 4, 4)
                 for s in range(n_seg))


def ice_self_collection(state: P3.P3State, loglambda, vel, rho_a, quad=None,
                        nodes=None, inner: str = "blocked"):
    """Aggregation loss rate of ice number [1/m^3/s] — the symmetric
    double integral ``1/2 ∬ n(D1) n(D2) K(D1, D2) |v(D1) - v(D2)|``
    (reference src/P3_processes.jl:676-712), computed as the ordered-pair
    integral over ``D2 < D1``, segment-blocked on the step-shared node
    table (``inner="blocked"``, the JAX package's default):

    * cross-segment blocks (``D2`` in a strictly lower mass-law segment
      than ``D1``) factorize ``K (v1 - v2)`` over ``K = pi (r1 + r2)^2``
      into six cumulative moments of the tabulated columns. The factored
      form drops ``|v1 - v2|``, so an inverted pair (``v2 > v1``) counts
      negatively, and a negative total becomes an ice-number source; this
      is the JAX package's behaviour and is kept for parity, not clamped;
    * within-segment triangles ``a_s < D2 < D1`` with fresh inner nodes
      (:func:`self_collection_inner_orders`).

    ``nodes`` must be laid out as the JAX package lays it out: ``n_seg``
    segments of ``quad.n`` nodes each, in segment order; another layout
    raises ``ValueError``.
    """
    if inner != "blocked":
        raise NotImplementedError(
            f"inner={inner!r} is not ported; only 'blocked'")
    if quad is None:
        quad = default_quadrature()
    dt = float_dtype(rho_a, loglambda)

    if nodes is None:
        nodes = P3.ice_quadrature_nodes(vel, rho_a, state, loglambda,
                                        machine_eps(dt), quad)

    n = quad.n
    n_seg = len(nodes.bnds) - 1
    if nodes.D.shape[0] != n_seg * n:
        raise ValueError(
            f"the node table has {nodes.D.shape[0]} rows; the blocked "
            f"self-collection slices {n_seg} segments of quad.n = {n}")
    D1 = nodes.D
    n_i = P3.size_distribution(state, loglambda)
    v_ice = P3.ice_particle_terminal_velocity(vel, rho_a, state)
    v1 = nodes.v
    r1 = torch.sqrt(P3.ice_area(state, D1) / PI)
    nw = nodes.nw
    total = torch.zeros_like(loglambda + rho_a)

    # (a) cross-segment blocks from the shared tables: six cumulative
    # moments S_m = sum nw r^m, T_m = sum nw r^m v of the lower segments
    seg_sums = []
    for t in range(n_seg):
        sl = slice(t * n, (t + 1) * n)
        nwt, rt, vt_ = nw[sl], r1[sl], v1[sl]
        nwr = nwt * rt
        nwr2 = nwr * rt
        seg_sums.append((
            sum_nodes(nwt), sum_nodes(nwr), sum_nodes(nwr2),
            sum_nodes(nwt * vt_), sum_nodes(nwr * vt_),
            sum_nodes(nwr2 * vt_)))
    prefix = [tuple(torch.zeros_like(x) for x in seg_sums[0])]
    for t in range(n_seg - 1):
        prefix.append(tuple(a + b for a, b in zip(prefix[-1], seg_sums[t])))
    for s in range(1, n_seg):
        sl_o = slice(s * n, (s + 1) * n)
        S0, S1, S2, T0, T1, T2 = prefix[s]
        ri, vi = r1[sl_o], v1[sl_o]
        cross_i = PI * (ri * ri * (vi * S0 - T0)
                        + 2 * ri * (vi * S1 - T1)
                        + (vi * S2 - T2))
        total = total + sum_nodes(cross_i * nw[sl_o])

    # (b) within-segment triangles with fresh inner nodes over the smooth,
    # single-regime span [a_s, D1]
    for s, n_in in enumerate(self_collection_inner_orders(n, n_seg)):
        inner_quad = GaussLegendre(n_in)
        sl_o = slice(s * n, (s + 1) * n)
        D1_s, v1_s, r1_s = D1[sl_o], v1[sl_o], r1[sl_o]
        a_s = nodes.bnds[s] + torch.zeros_like(D1_s)
        acc = torch.zeros_like(D1_s)
        for D2, w2 in _node_iter(inner_quad, a_s, D1_s):
            v2 = v_ice(D2)
            r2 = torch.sqrt(P3.ice_area(state, D2) / PI)
            K = PI * (r1_s + r2) ** 2
            acc = acc + K * torch.abs(v1_s - v2) * n_i(D2) * w2
        total = total + sum_nodes(acc * nw[sl_o])
    return total
