"""2M warm rain + P3 ice column step as three hand-written CUDA kernels,
beside its plain PyTorch version.

Port of ``cloudmicrophysics_tpu/kernels/column_p3.py``. The CUDA source
``csrc/column_p3.cu`` (with the warm-rain device code of ``csrc/warm2m.cuh``,
shared with the 2M kernel) computes everything
:func:`..models.column.step_column_p3` computes, in three kernels launched
one after the other on the current stream and joined by a float32 scratch
record of :data:`SCRATCH_FIELDS` rows of ``ncol * nlev`` (:func:`launch_plan`
gives their grids):

* K5a (:func:`launch_solve`), a thread per cell: the P3 shape solve
  (warm-started from an optional ``loglambda_guess``), the sanitized state,
  the PSD and the integration bounds, the cloud window of the collisions
  and the node pass's per-cell factors; :func:`loglambda_p3_fused` runs it
  alone;
* K5b (:func:`launch_nodes`), a warp per cell (half a warp at order 4), a
  lane per ice quadrature node: every contraction over the ice nodes
  (liquid-ice collisions, blocked self-collection, melt, the weighted fall
  speeds), each node-axis sum added one node at a time in node order;
* K5c (:func:`launch_epilogue`), a thread per cell in blocks of whole
  columns: the nucleation, freezing, sublimation/deposition and
  number-adjustment rates, the SB2006 warm rates, rain and ice
  sedimentation, latent heating, the clamp and ``q_rim <= q_ice``.

:func:`step_column_p3_fused` runs the three and returns ``(new_state,
loglambda)``.

A CPU tensor takes the plain version (:func:`step_column_p3_plain`, the eager
step). A CUDA tensor launches the kernels, or raises ``NotImplementedError``
for what they do not cover: dtypes other than float32, more than 256
levels, quadrature orders other than 4, 8 and 16 (compiled variants of
K5b), a slope law other than ``SlopePowerLaw``, an aspect ratio other than
``Oblate``, ice nucleation other than ``Frostenberg2023``, an unlimited ice
rain PSD, and the 2M kernel's exclusions. Both ``is_limited`` values and
both rain velocity types of the warm rain are compiled variants of K5c,
picked at launch; any float override is data in the parameter buffer.

The kernels read the parameters from one float32 device buffer built on
the host in float64 by :func:`kernel_params_p3`: the scalars, in the order of
:data:`PARAM_NAMES` (which starts with the 2M kernel's list, so the shared
warm-rain code reads the same indices), then the Gauss node/weight tables of
the compiled order. The build writes the matching ``#define P_<name>``
header from :data:`PARAM_NAMES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.column import ColumnStateP3, step_column_p3
from ..ops import common as CO
from ..ops import p3 as P3
from ..ops import thermo as TDI
from ..ops.p3_processes import liquid_quadrature, self_collection_inner_orders
from ..parameters.ice_nucleation import Frostenberg2023
from ..parameters.p3 import OBLATE, SlopePowerLaw
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.quadrature import GaussLegendre
from ..utils.special import machine_eps
from . import _build
from . import column2m as K2M
from .column1m import _check_cuda, _check_tiling

__all__ = [
    "ORDERS",
    "PARAM_NAMES",
    "SCRATCH_FIELDS",
    "kernel_params_p3",
    "launch_plan",
    "loglambda_p3_fused",
    "loglambda_p3_plain",
    "step_column_p3_fused",
    "step_column_p3_plain",
]

# K5c's threads per block (kEpiThreads in csrc/column_p3.cu): a block steps
# whole columns, so nlev may not exceed it.
MAX_NLEV = 256

# Quadrature orders with a compiled variant of the kernel.
ORDERS = (4, 8, 16)

# Second blocks, in the order of the 2M blocks they shadow: the ice rain PSD
# (read by the shared pdf_rain at an offset) and the ice container's Chen
# 2022 rain coefficients (read by the shared chen_rain_coeffs at an offset).
_RAIN_PDF_BLOCK = ("XR_MIN", "XR_MAX", "N0_MIN", "N0_MAX", "LAM_MIN",
                   "LAM_MAX", "PI_RHO_W")
_CHEN_BLOCK = ("CH_RHO0", "CH_BRHO", "LOG1000", "CH_A1U", "CH_A2U", "CH_A3U",
               "CH_A3POW", "CH_B1", "CH_B2", "CH_B3", "CH_C1U", "CH_C2U",
               "CH_C3U")
ICE_RAIN_PDF_NAMES = tuple("IR_" + n for n in _RAIN_PDF_BLOCK)
ICE_CHEN_NAMES = tuple("IC_" + n.removeprefix("CH_") for n in _CHEN_BLOCK)

PARAM_NAMES = K2M.PARAM_NAMES + ICE_RAIN_PDF_NAMES + ICE_CHEN_NAMES + (
    # numerics: thresholds, incomplete gamma, Lanczos, probabilities
    "ONE_M_EPS", "EPS2", "TWO_EPS", "BIG", "GI_TINY", "GI_BIG",
    "HALF_LOG_2PI", "SGS_UPPER", "SGS_K", "SGS_LO", "SGS_HI",
    "IB_P_LO", "IB_Q_LO", "IB_P_HI", "IB_Q_HI",
    "CB_P_LO", "CB_Q_LO", "CB_P_HI", "CB_Q_HI",
    # thermodynamics
    "LH_F0", "CPLI", "LH_S0", "DCP_VI", "KV_I", "CL_I", "T_FRZ", "T_FRZ_M4",
    "E_SI_FRZ", "CP_L", "K_THERM", "D_VAPOR", "FOUR_K_THERM", "TAU_SD",
    # P3 scheme: mass, area, slope, rime, ventilation
    "PI_F", "INV_PI", "ALPHA_VA", "BETA_VA", "RHO_I", "INV_RHO_I", "RHOI_PI6",
    "SIX_ALPHA", "THR_EXP", "D_TH", "RHO_RIM_MAX", "RHOD_NEGP", "RHOD_1MP",
    "THREE_SQRT_PI", "AREA_GAMMA", "AREA_SIGMA", "SLOPE_A", "SLOPE_B",
    "SLOPE_C", "MU_MAX", "P3_T_FREEZE", "INV_TAU_WET", "P3_VENT_A",
    "P3_VENT_BC", "RRL_A", "RRL_B", "RRL_C", "RRL_RHO8", "RRL_RHO_ICE",
    # Chen 2022 ice velocities
    "CS_A", "CS_B", "CS_C", "CS_E", "CS_F", "CS_C0U", "CS_C1U",
    "CL_A", "CL_B", "CL_E", "CL_H", "CL_U0", "CL_U1", "CL_B0", "CL_B1",
    "CL_C0U", "CL_C1U", "CUTOFF",
    # liquid PSDs of the collisions and the Bigg freezing
    "RHO_W", "IR_RHO_W", "K2", "INV_M_SHD", "CPDF_MU", "CPDF_NEG_MU",
    "CPDF_LG1", "CPDF_LG2", "CPDF_Z1", "CPDF_NU1", "CPDF_KM",
    "CPDF_KM_POW_MU", "CPDF_NUD", "CPDF_MUD", "CB_A", "CB_INV_MU",
    "LOG1P_NEG_P", "LOG1P_NEG_1MP", "GGM_E3", "GGM_E6", "GGM_R3", "GGM_R6",
    "V1", "V1SQ", "HET_A", "HET_B",
    # F23 nucleation and the ice number adjustment
    "F23_T_FREEZE", "F23_NEG_B", "F23_LOG_A", "F23_T_THRESH", "S_I_THRESH",
    "INV_TEN", "INV_TAU_ACT", "INV_2TAU_ACT", "M_NUC", "INV_XI_MIN",
    "INV_XI_MAX", "INV_TAU_NI",
)


def _p_sat_ice_at_freezing(tps: ThermodynamicsParameters) -> float:
    """The saturation vapor pressure over ice at ``tps.T_freeze``, a Python
    float (the eager step folds it on the host, in float64)."""
    T = torch.tensor(tps.T_freeze, dtype=torch.float64)
    return float(TDI.saturation_vapor_pressure_over_ice(tps, T))


def _param_values_p3(mp, tps: ThermodynamicsParameters) -> dict:
    """Every scalar the kernel reads, keyed by :data:`PARAM_NAMES`. The
    products the eager code folds from Python floats are folded here the
    same way, in float64; ``INV_<x>`` is ``1/x`` in float64 (PyTorch's CUDA
    division of a tensor by a Python float multiplies by that reciprocal,
    rounded once to float32). The tail probabilities are the float32 values
    the eager step forms from its float32 tensors."""
    ice = mp.ice
    p3 = ice.scheme
    aps = mp.warm_rain.air_properties
    vel = ice.terminal_velocity
    pdf_c, pdf_r = ice.cloud_pdf, ice.rain_pdf
    f32 = torch.float32
    eps = machine_eps(f32)
    pi = math.pi

    v = K2M._param_values(mp, tps)
    # the second blocks: the ice rain PSD and the ice Chen rain coefficients
    ice_rain = K2M.rain_pdf_values(pdf_r)
    ice_chen = K2M.chen_rain_values(vel.rain)
    for name, src in zip(ICE_RAIN_PDF_NAMES, _RAIN_PDF_BLOCK):
        v[name] = ice_rain[src]
    for name, src in zip(ICE_CHEN_NAMES, _CHEN_BLOCK):
        v[name] = ice_chen[src]

    # probabilities as the eager step rounds them in float32
    one = np.float32(1.0)
    ib_p_lo = np.float32(1e-6)
    ib_p_hi = np.float32(1 - 1e-6)
    cb_p_hi = one - ib_p_lo
    nuD, muD = 3 * pdf_c.nu_c + 2, 3 * pdf_c.mu_c
    k_m = pdf_c.rho_w * pi / 6
    gd = math.lgamma((nuD + 1) / muD)
    mass = p3.mass
    p = 1 / (3 - mass.beta_va)
    As, Bs, Cs, Es, Fs, Gs = CO.chen2022_small_ice_consts(
        vel.small_ice, P3.ICE_VELOCITY_RHO_I)
    Al, Bl, Cl, El, Fl, Gl, Hl = CO.chen2022_large_ice_consts(
        vel.large_ice, P3.ICE_VELOCITY_RHO_I)
    f23 = ice.ice_nucleation
    tau_act = ice.inp_depletion_model.tau_act
    rrl = p3.rho_rim_local
    dcp_vi = tps.cp_v - tps.cp_i

    v.update(
        ONE_M_EPS=1 - eps, EPS2=eps**2,
        TWO_EPS=2 * eps, BIG=float(torch.finfo(f32).max), GI_TINY=1e-30,
        GI_BIG=1 / 1e-30, HALF_LOG_2PI=0.5 * math.log(2 * math.pi),
        SGS_UPPER=min(1.0 - eps, 42.0 * eps), SGS_K=-1.0 / math.log2(1.0 - eps),
        SGS_LO=-1.0 + eps, SGS_HI=min(1.0, 42.0 * eps),
        IB_P_LO=ib_p_lo, IB_Q_LO=one - ib_p_lo, IB_P_HI=ib_p_hi,
        IB_Q_HI=one - ib_p_hi,
        CB_P_LO=ib_p_lo, CB_Q_LO=one - ib_p_lo, CB_P_HI=cb_p_hi,
        CB_Q_HI=one - cb_p_hi,
        LH_F0=tps.LH_f0, CPLI=tps.cp_l - tps.cp_i, LH_S0=tps.LH_s0,
        DCP_VI=dcp_vi, KV_I=dcp_vi / tps.R_v,
        CL_I=(tps.LH_s0 - dcp_vi * tps.T_0) / tps.R_v, T_FRZ=tps.T_freeze,
        T_FRZ_M4=tps.T_freeze - 4,
        E_SI_FRZ=_p_sat_ice_at_freezing(tps),
        CP_L=tps.cp_l, K_THERM=aps.K_therm, D_VAPOR=aps.D_vapor,
        FOUR_K_THERM=4 * aps.K_therm, TAU_SD=mp.warm_rain.subdep.tau_relax,
        PI_F=pi, INV_PI=1 / pi, ALPHA_VA=mass.alpha_va, BETA_VA=mass.beta_va,
        RHO_I=p3.rho_i, INV_RHO_I=1 / p3.rho_i, RHOI_PI6=p3.rho_i * pi / 6,
        SIX_ALPHA=6 * mass.alpha_va, THR_EXP=p,
        D_TH=(6 * mass.alpha_va / (pi * p3.rho_i)) ** p,
        RHO_RIM_MAX=0.8 * p3.rho_l, RHOD_NEGP=-p, RHOD_1MP=1 - p,
        THREE_SQRT_PI=3 * math.sqrt(pi), AREA_GAMMA=p3.area.gamma,
        AREA_SIGMA=p3.area.sigma, SLOPE_A=p3.slope.a, SLOPE_B=p3.slope.b,
        SLOPE_C=p3.slope.c, MU_MAX=p3.slope.mu_max, P3_T_FREEZE=p3.T_freeze,
        INV_TAU_WET=1 / p3.tau_wet, P3_VENT_A=p3.vent.av,
        P3_VENT_BC=p3.vent.bv * (aps.nu_air / aps.D_vapor) ** (1.0 / 3.0),
        RRL_A=rrl.a, RRL_B=rrl.b, RRL_C=rrl.c,
        RRL_RHO8=rrl.a + rrl.b * 8.0 + rrl.c * 64.0, RRL_RHO_ICE=rrl.rho_ice,
        CS_A=As, CS_B=Bs, CS_C=Cs, CS_E=Es, CS_F=Fs, CS_C0U=0.0 * Gs,
        CS_C1U=Gs * 1000.0, CL_A=Al, CL_B=Bl, CL_E=El, CL_H=Hl,
        CL_U0=1000.0**Cl, CL_U1=1000.0**Fl, CL_B0=Cl, CL_B1=Fl,
        CL_C0U=0.0 * Gl * 1000.0, CL_C1U=Gl * 1000.0,
        CUTOFF=vel.small_ice.cutoff,
        RHO_W=pdf_c.rho_w, IR_RHO_W=pdf_r.rho_w, K2=pi / 4,
        INV_M_SHD=1 / (pdf_c.rho_w * (1e-3**3 * pi / 6)),
        CPDF_MU=pdf_c.mu_c, CPDF_NEG_MU=-pdf_c.mu_c,
        CPDF_LG1=pdf_c.loggamma_z1, CPDF_LG2=pdf_c.loggamma_z2,
        CPDF_Z1=(pdf_c.nu_c + 1) / pdf_c.mu_c, CPDF_NU1=pdf_c.nu_c + 1,
        CPDF_KM=k_m, CPDF_KM_POW_MU=k_m**pdf_c.mu_c, CPDF_NUD=nuD,
        CPDF_MUD=muD, CB_A=(nuD + 1) / muD, CB_INV_MU=1 / muD,
        LOG1P_NEG_P=math.log1p(-1e-6), LOG1P_NEG_1MP=math.log1p(-(1 - 1e-6)),
        GGM_E3=-3 / muD, GGM_E6=-6 / muD,
        GGM_R3=math.exp(math.lgamma((nuD + 1 + 3) / muD) - gd),
        GGM_R6=math.exp(math.lgamma((nuD + 1 + 6) / muD) - gd),
        V1=pi / 6, V1SQ=(pi / 6) ** 2,
        HET_A=ice.rain_freezing.het_a, HET_B=ice.rain_freezing.het_B,
        F23_T_FREEZE=f23.T_freeze, F23_NEG_B=-f23.b, F23_LOG_A=f23.log_a,
        F23_T_THRESH=f23.T_freeze - 15, S_I_THRESH=0.05, INV_TEN=1 / 10,
        INV_TAU_ACT=1 / tau_act, INV_2TAU_ACT=1 / (2 * tau_act),
        M_NUC=p3.rho_i * pi / 6 * 10e-6**3,
        INV_XI_MIN=1 / ice.numadj.x_min, INV_XI_MAX=1 / ice.numadj.x_max,
        INV_TAU_NI=1 / ice.numadj.tau,
    )
    return v


def _tables(mp) -> np.ndarray:
    """The node/weight tables behind the scalars, float64, in the kernel's
    order: ice (the container's rule), liquid (half order, floor 8, above
    order 8; the ice rule otherwise), self-collection inner and tail
    (Gauss-Legendre of a quarter order, floors 4 and 6)."""
    quad = mp.ice.quad
    n = quad.n
    inner, tail = self_collection_inner_orders(n)[0], \
        self_collection_inner_orders(n)[-1]
    parts = []
    for rule in (quad, liquid_quadrature(quad), GaussLegendre(inner),
                 GaussLegendre(tail)):
        y, w = rule.nodes_weights()
        parts += [np.asarray(y, np.float64).ravel(),
                  np.asarray(w, np.float64).ravel()]
    return np.concatenate(parts)


def kernel_params_p3(mp, tps: ThermodynamicsParameters,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """The kernel's float32 parameter buffer: the scalars in
    :data:`PARAM_NAMES` order, then the node/weight tables."""
    values = _param_values_p3(mp, tps)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    scalars = np.array([float(values[n]) for n in PARAM_NAMES], np.float64)
    buf = np.concatenate([scalars, _tables(mp)])
    return torch.tensor(buf, dtype=torch.float64, device=device).to(
        torch.float32)


# ---------------------------------------------------------------------------
# Plain version (eager PyTorch): the CPU path and the kernel's reference
# ---------------------------------------------------------------------------

def step_column_p3_plain(state: ColumnStateP3, mp, tps, dt, dz,
                         loglambda_guess=None, col_chunks=None):
    """What :func:`step_column_p3_fused` computes, in eager PyTorch
    (``step_column_p3(..., impl="eager")``); ``col_chunks`` bounds the
    memory of the eager node and pair-space tensors."""
    return step_column_p3(state, mp, tps, dt, dz, loglambda_guess,
                          col_chunks=col_chunks, impl="eager")


def loglambda_p3_plain(state: ColumnStateP3, mp, loglambda_guess=None):
    """What :func:`loglambda_p3_fused` computes, in eager PyTorch: the P3
    shape solve on the raw state, as :func:`step_column_p3` runs it."""
    rho = state.rho
    pstate = P3.state_from_prognostic(
        mp.ice.scheme, state.q_ice * rho, state.n_ice * rho,
        state.q_rim * rho, state.b_rim * rho)
    with torch.no_grad():
        return P3.get_distribution_loglambda(pstate, loglambda_guess)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Threads per block of K5a, K5b and at most K5c (kSolveThreads, kNodeThreads,
# kEpiThreads in csrc/column_p3.cu).
SOLVE_THREADS, NODE_THREADS, EPILOGUE_THREADS = 128, 128, 256

# The scratch record between the kernels, one (ncol * nlev) row per field
# (enum Scratch in csrc/column_p3.cu): K5a's sanitized state, PSD, bounds and
# per-cell factors of the node pass, then K5b's node-pass sums.
SCRATCH_FIELDS = (
    "L", "N", "F", "rho_rim", "rho_g", "D_gr", "D_cr", "mu", "lam", "log_N0",
    "b0", "b1", "b2", "b3", "b4", "c_lo", "c_hi",
    "vc_as0", "vc_as1", "vc_bs", "vc_al0", "vc_al1",
    "rain_ok", "r_lo", "r_hi", "r_n0", "r_dm", "cp_logN0", "cp_lam",
    "cr_a0", "cr_a1", "cr_a2", "cr_b0", "cr_b1", "cr_b2",
    "inv_2Tc", "frz_num", "frz_den",
    "QCFRZ", "QCSHD", "NCCOL", "QRFRZ", "QRSHD", "NRCOL", "INT_M", "BCCOL",
    "BRCOL", "INT_WET", "melt", "vn", "vm", "agg",
)


class LaunchPlan(NamedTuple):
    """Grids and blocks of K5's three kernels for one step."""

    scratch_shape: tuple      # (len(SCRATCH_FIELDS), ncol * nlev)
    solve_grid: int           # K5a: a thread per cell, SOLVE_THREADS a block
    nodes_grid: int           # K5b: lanes_per_cell lanes per cell
    lanes_per_cell: int
    cells_per_block: int      # K5b cells per NODE_THREADS block
    epilogue_cols: int        # K5c: whole columns per block
    epilogue_block: int       # K5c threads per block (epilogue_cols * nlev)
    epilogue_grid: int


def lanes_per_cell(order: int) -> int:
    """K5b's lanes per cell: one per ice node (4 segments x ``order``
    nodes), at most a warp."""
    return min(32, 4 * order)


def launch_plan(ncol: int, nlev: int, order: int,
                block_cols: int) -> LaunchPlan:
    """The launch plan of one K5 step on ``(ncol, nlev)`` fields at
    quadrature ``order``. ``block_cols`` must divide ``ncol``; K5c's block
    steps the largest divisor of ``block_cols`` whose columns fit in
    EPILOGUE_THREADS threads (so that the blocks fill the card however
    large ``block_cols`` is)."""
    _check_tiling(ncol, block_cols)
    if nlev > MAX_NLEV:
        raise NotImplementedError(
            f"the CUDA P3 column kernel supports nlev <= {MAX_NLEV}, "
            f"not {nlev}")
    if order not in ORDERS:
        raise NotImplementedError(
            f"the CUDA P3 column kernel supports quadrature orders {ORDERS}, "
            f"not {order}")
    ncells = ncol * nlev
    lanes = lanes_per_cell(order)
    per_block = NODE_THREADS // lanes
    fit = EPILOGUE_THREADS // nlev
    cols = max(d for d in range(1, min(block_cols, fit) + 1)
               if block_cols % d == 0)
    return LaunchPlan(
        scratch_shape=(len(SCRATCH_FIELDS), ncells),
        solve_grid=-(-ncells // SOLVE_THREADS),
        nodes_grid=-(-ncells // per_block),
        lanes_per_cell=lanes, cells_per_block=per_block,
        epilogue_cols=cols, epilogue_block=cols * nlev,
        epilogue_grid=ncol // cols)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

SOURCE = "column_p3.cu"
# nvcc flags of each build of the source: the one the wrappers launch
# (-lineinfo leaves the code as it is and maps each SASS instruction to its
# source line, which kernels/opcount.py reads) and the operation-count
# probe.
BUILDS = {
    "kernel": ("-lineinfo",),
    "probe": ("-lineinfo", "-DK5_PROBE"),
}


def _header() -> str:
    return _build.index_header(PARAM_NAMES, "COLUMN_P3_PARAMS_H")


def library_path(build: str = "kernel"):
    """The file of one of the kernel library's :data:`BUILDS` (built if
    needed)."""
    return _build.build(SOURCE, "column_p3_params.h", _header(),
                        BUILDS[build])


def _library(build: str = "kernel") -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS`, loaded."""
    lib = _build.load(SOURCE, "column_p3_params.h", _header(), BUILDS[build])
    if not getattr(lib, "_signatures_set", False):
        lib.column_p3_solve.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I, _P]
        lib.column_p3_nodes.argtypes = [_P, _P, _P, _I, _L, _I, _I, _P]
        lib.column_p3_epilogue.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _F, _F, _I, _I, _I, _P]
        for fn in (lib.column_p3_solve, lib.column_p3_nodes,
                   lib.column_p3_epilogue, lib.column_p3_num_params,
                   lib.column_p3_scratch_fields):
            fn.restype = _I
        for fn in (lib.column_p3_threads, lib.column_p3_lanes_per_cell,
                   lib.column_p3_table_len):
            fn.argtypes, fn.restype = [_I], _I
        lib.column_p3_kernel_attrs.argtypes = [_I, _I, _P]
        lib.column_p3_kernel_attrs.restype = _I
        if build == "probe":
            lib.column_p3_probe_set.argtypes = [_P, _L, _I]
            lib.column_p3_probe_set.restype = _I
            lib.column_p3_probe_regions.restype = _I
        if lib.column_p3_num_params() != len(PARAM_NAMES):
            raise RuntimeError("column_p3 library built from another "
                               "parameter list")
        if lib.column_p3_scratch_fields() != len(SCRATCH_FIELDS):
            raise RuntimeError("column_p3 library built with another "
                               "scratch record")
        threads = (SOLVE_THREADS, NODE_THREADS, EPILOGUE_THREADS)
        if tuple(lib.column_p3_threads(k) for k in range(3)) != threads:
            raise RuntimeError("column_p3 library built with other block "
                               "sizes")
        for order in ORDERS:
            if (lib.column_p3_table_len(order) != _table_len(order)
                    or lib.column_p3_lanes_per_cell(order)
                    != lanes_per_cell(order)):
                raise RuntimeError("column_p3 library built with other "
                                   "quadrature tables")
        lib._signatures_set = True
    return lib


def kernel_attrs(lib: ctypes.CDLL, order: int) -> dict:
    """Registers, local memory bytes per thread, static shared memory
    bytes and the largest block of K5a, K5b (at ``order``) and K5c, as the
    CUDA runtime reports them."""
    out = {}
    for k, name in enumerate(("K5a", "K5b", "K5c")):
        vals = (ctypes.c_int * 4)()
        err = lib.column_p3_kernel_attrs(k, order, vals)
        if err:
            raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error "
                               f"{err}")
        out[name] = dict(zip(("registers", "local_bytes", "shared_bytes",
                              "max_threads"), vals))
    return out


def _table_len(order: int) -> int:
    nl = liquid_quadrature(GaussLegendre(order)).n
    inner = self_collection_inner_orders(order)
    return 2 * (order + nl + inner[0] + inner[-1])


def _check_supported(mp, nlev: int, dtype: torch.dtype) -> None:
    ice = getattr(mp, "ice", None)
    if ice is None:
        raise NotImplementedError(
            "the CUDA P3 column kernel needs the P3 ice parameters (mp.ice)")
    if nlev > MAX_NLEV:
        raise NotImplementedError(
            f"the CUDA P3 column kernel supports nlev <= {MAX_NLEV}, "
            f"not {nlev}")
    K2M._check_supported(
        type(mp)(warm_rain=mp.warm_rain, ice=None), nlev, dtype)
    if ice.quadrature_order not in ORDERS or ice.quad.n != ice.quadrature_order:
        raise NotImplementedError(
            f"the CUDA P3 column kernel supports quadrature orders {ORDERS}, "
            f"not {ice.quadrature_order}")
    scheme = ice.scheme
    if not isinstance(scheme.slope, SlopePowerLaw):
        raise NotImplementedError(
            "the CUDA P3 column kernel supports the SlopePowerLaw slope law, "
            f"not {type(scheme.slope).__name__}")
    if scheme.aspect_ratio != OBLATE:
        raise NotImplementedError(
            f"the CUDA P3 column kernel supports aspect_ratio={OBLATE!r}, "
            f"not {scheme.aspect_ratio!r}")
    if not isinstance(ice.ice_nucleation, Frostenberg2023):
        raise NotImplementedError(
            "the CUDA P3 column kernel supports Frostenberg2023 ice "
            f"nucleation, not {type(ice.ice_nucleation).__name__}")
    if not ice.rain_pdf.is_limited:
        raise NotImplementedError(
            "the CUDA P3 column kernel supports the limited ice rain PSD "
            "(mp.ice.rain_pdf.is_limited)")


def _device_params(params, mp, tps, device) -> torch.Tensor:
    n = len(PARAM_NAMES) + _table_len(mp.ice.quadrature_order)
    if params is None:
        return kernel_params_p3(mp, tps, device=device)
    if (params.device != device or params.dtype != torch.float32
            or params.shape != (n,) or not params.is_contiguous()):
        raise ValueError(
            f"params must be a contiguous float32 ({n},) tensor on {device}")
    return params


def _ptrs(tensors) -> ctypes.c_void_p:
    arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    return ctypes.cast(arr, ctypes.c_void_p)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def launch_solve(lib, state, guess, loglam, scratch, params, plan, device):
    """K5a on the current stream: ``loglam`` and the first rows of
    ``scratch`` from ``state`` (and the warm-start ``guess`` or None)."""
    _raise_on(lib.column_p3_solve(
        _ptrs(state), None if guess is None else guess.data_ptr(),
        loglam.data_ptr(), scratch.data_ptr(), params.data_ptr(),
        state.rho.numel(), plan.solve_grid, device.index,
        torch.cuda.current_stream(device).cuda_stream), "column_p3_solve")
    launch_solve.launches += 1


def launch_nodes(lib, state, scratch, params, order, plan, device):
    """K5b on the current stream: the node-pass sums of ``scratch``."""
    _raise_on(lib.column_p3_nodes(
        _ptrs(state), scratch.data_ptr(), params.data_ptr(), order,
        state.rho.numel(), plan.nodes_grid, device.index,
        torch.cuda.current_stream(device).cuda_stream), "column_p3_nodes")
    launch_nodes.launches += 1


def launch_epilogue(lib, state, out, scratch, params, plan, dt, dz, variant,
                    device):
    """K5c on the current stream: the eleven fields of ``out``."""
    ncol, nlev = state.rho.shape
    limited, chen = variant
    _raise_on(lib.column_p3_epilogue(
        _ptrs(state), _ptrs(out), scratch.data_ptr(), params.data_ptr(),
        ncol, nlev, plan.epilogue_cols, plan.epilogue_grid, float(dt),
        float(dz), limited, chen, device.index,
        torch.cuda.current_stream(device).cuda_stream), "column_p3_epilogue")
    launch_epilogue.launches += 1


launch_solve.launches = launch_nodes.launches = launch_epilogue.launches = 0


def _check_fields(state, loglambda_guess, block_cols, where):
    ncol, nlev = state.rho.shape
    _check_tiling(ncol, block_cols)
    tensors = list(state) + ([] if loglambda_guess is None
                             else [loglambda_guess])
    for t in tensors:
        if t.shape != (ncol, nlev):
            raise ValueError(f"every field must be {(ncol, nlev)}, "
                             f"got {tuple(t.shape)}")
    if state.rho.device.type == "cpu":
        return None
    return _check_cuda(tensors, where)


def loglambda_p3_fused(state: ColumnStateP3, mp, tps, loglambda_guess=None,
                       params=None):
    """K5a alone: the P3 shape solve's ``(ncol, nlev)`` log lambda, warm-
    started from ``loglambda_guess`` when given. CPU tensors take
    :func:`loglambda_p3_plain`."""
    device = _check_fields(state, loglambda_guess, 1, "loglambda_p3_fused")
    if device is None:
        return loglambda_p3_plain(state, mp, loglambda_guess)
    ncol, nlev = state.rho.shape
    _check_supported(mp, nlev, state.rho.dtype)
    plan = launch_plan(ncol, nlev, mp.ice.quadrature_order, 1)
    params = _device_params(params, mp, tps, device)
    loglam = torch.empty_like(state.rho)
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                          device=device)
    launch_solve(_library(), state, loglambda_guess, loglam, scratch, params,
                 plan, device)
    return loglam


def step_column_p3_fused(state: ColumnStateP3, mp, tps, dt, dz,
                         loglambda_guess=None, block_cols: int = 128,
                         params=None):
    """One 2M + P3 column step on eleven ``(ncol, nlev)`` fields; returns
    ``(new_state, loglambda)`` like :func:`step_column_p3`.

    On CUDA tensors it launches K5a (shape solve and bounds), K5b (ice node
    pass) and K5c (rates, sedimentation, update) on the current stream,
    joined by a ``(len(SCRATCH_FIELDS), ncol * nlev)`` float32 scratch
    record it allocates (see :func:`launch_plan`). ``loglambda_guess``: an
    optional ``(ncol, nlev)`` warm start for the shape solve (the previous
    step's ``loglambda``). ``ncol`` must be a multiple of ``block_cols``.
    ``params``: the buffer of :func:`kernel_params_p3`, built here when not
    given. CPU tensors take :func:`step_column_p3_plain`.
    """
    device = _check_fields(state, loglambda_guess, block_cols,
                           "step_column_p3_fused")
    if device is None:
        return step_column_p3_plain(state, mp, tps, dt, dz, loglambda_guess)
    ncol, nlev = state.rho.shape
    _check_supported(mp, nlev, state.rho.dtype)
    order = mp.ice.quadrature_order
    plan = launch_plan(ncol, nlev, order, block_cols)
    params = _device_params(params, mp, tps, device)
    lib = _library()
    out = ColumnStateP3(*(torch.empty_like(t) for t in state))
    loglam = torch.empty_like(state.rho)
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                          device=device)
    variant = K2M._variant(type(mp)(warm_rain=mp.warm_rain, ice=None))
    launch_solve(lib, state, loglambda_guess, loglam, scratch, params, plan,
                 device)
    launch_nodes(lib, state, scratch, params, order, plan, device)
    launch_epilogue(lib, state, out, scratch, params, plan, dt, dz, variant,
                    device)
    step_column_p3_fused.launches += 1
    return out, loglam


step_column_p3_fused.launches = 0
