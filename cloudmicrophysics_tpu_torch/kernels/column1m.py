"""Fused 1M column step as one hand-written CUDA kernel, beside its plain
PyTorch version.

Port of ``cloudmicrophysics_tpu/kernels/column1m.py``. The CUDA source
``csrc/column1m.cu`` computes, per ``(column, level)`` cell and in one
pass over the seven prognostic fields, everything
:func:`..models.column.step_column_1m` computes: the shared 1M PSD
parameters, the 18 source terms, the rain/snow/cloud fall speeds, the
upwind sedimentation fluxes, the latent-heat temperature update and the
final clamp. Two entry points share it:

* :func:`step_column_1m_fused` — seven ``(ncol, nlev)`` fields in, seven
  out (the Pallas ``step_column_1m_pallas``);
* :func:`step_column_1m_fused_packed` — one ``(7, ncol, nlev)`` buffer in
  and out (the Pallas ``step_column_1m_pallas_packed``).

A CPU tensor takes the plain version (:func:`step_column_1m_plain`,
:func:`step_column_1m_packed_plain`). A CUDA tensor launches the kernel,
or raises ``NotImplementedError`` for what the kernel does not cover:
modes other than ``"instantaneous"``, option selections other than the
default :class:`~..parameters.m1.Microphysics1MOptions`, dtypes other than
float32, and more than 256 levels.

The kernel reads the parameters from one float32 device buffer, built on
the host in float64 by :func:`kernel_params`. :data:`PARAM_NAMES` is the
only definition of its order: the build writes the matching
``#define P_<name> <index>`` header from it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.column import ColumnState, step_column_1m
from ..parameters.m1 import Microphysics1MOptions, Microphysics1MParams
from ..parameters.terminal_velocity import TerminalVelocityParams
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import eps_numerics
from . import _build

__all__ = [
    "PARAM_NAMES",
    "kernel_params",
    "pack_state",
    "step_column_1m_fused",
    "step_column_1m_fused_packed",
    "step_column_1m_packed_plain",
    "step_column_1m_plain",
    "unpack_state",
]

_FIELDS = ColumnState._fields  # (rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno)

# Threads per block of the kernel (kThreads in csrc/column1m.cu): a block
# steps whole columns, so nlev may not exceed it.
MAX_NLEV = 256

PARAM_NAMES = (
    # float32 constants of the dtype
    "EPS", "TINY", "LOG_EPS", "HALF_MIN", "LOG_TINY",
    # thermodynamics
    "T_0", "LH_V0", "LH_S0", "LH_F0", "DCP_VL", "DCP_VI", "DCP_LI",
    "CP_D", "CPVD", "CPLV", "CPIV", "CV_L", "T_TRIPLE", "INV_T_TRIPLE",
    "PRESS_TRIPLE", "KV_L", "CL_L", "KV_I", "CL_I", "R_V", "T_FREEZE",
    # air
    "K_THERM", "K_THERM_SAFE", "D_VAPOR_SAFE", "NU_AIR",
    # PSD: snow intercept, lambda in log space
    "LOG_MU_SNO", "NU_SNO",
    "POW_RAI", "LOGNUM_RAI", "LOGDEN_RAI", "LOGFLOOR_RAI", "LOG_R0_RAI",
    "POW_SNO", "LOGNUM_SNO", "LOGC_SNO", "LOGFLOOR_SNO", "LOG_R0_SNO",
    "POW_ICL", "LOGNUM_ICL", "LOGDEN_ICL", "LOGFLOOR_ICL",
    "N0_RAI", "N0_ICL",
    # rain fall-speed coefficient v0(rho)
    "V0C_RAI", "RHO_W_VEL_RAI", "GRAV_VEL_RAI", "R0_VEL_RAI",
    # cloud condensate formation
    "TAU_LCL", "TAU_ICL",
    # autoconversion (logistic integral)
    "ACNV_R_X0S", "ACNV_R_K", "ACNV_R_TRN", "ACNV_R_X0LT", "ACNV_R_TAU",
    "ACNV_S_X0S", "ACNV_S_K", "ACNV_S_TRN", "ACNV_S_X0LT", "ACNV_S_TAU",
    # accretion
    "E_LR", "E_LS", "E_IR", "E_IS", "E_RS", "CD_RS",
    "A0_RAI", "CHIA_RAI", "CHIV_RAI", "GACC_RAI", "PACC_RAI",
    "A0_SNO", "V0_SNO", "CHIA_SNO", "CHIV_SNO", "GACC_SNO", "PACC_SNO",
    "M0_RAI", "CHIM_RAI", "GSINK_RAI", "PSINK_RAI",
    # bulk terminal velocities
    "PVT_RAI", "GTERM_RAI", "GC_RAI", "CV0_SNO", "PVT_SNO", "GTERM_SNO",
    "GC_SNO",
    # rain-snow collisions
    "PI", "M0_SNO", "CHIM_SNO", "R0D_RAI", "R0D_SNO",
    "EXP1_RAI", "EXP2_RAI", "EXP3_RAI", "C2_RAI", "C3_RAI",
    "EXP1_SNO", "EXP2_SNO", "EXP3_SNO", "C2_SNO", "C3_SNO",
    # evaporation, sublimation, melt
    "VA_RAI", "VBSC_RAI", "PVENT_RAI", "GVENT_RAI", "C4PI_N0_RAI",
    "VA_SNO", "VBSC_SNO", "PVENT_SNO", "GVENT_SNO", "SQ_SNO", "PI4",
    "C4PI_N0_ICL",
    # cloud sedimentation: Stokes liquid, Chen 2022 small ice
    "C18", "RHO_W_STOKES", "GRAV_STOKES", "NU_STOKES", "C6PI", "C23",
    "N0_LCL", "RHO_W_LCL",
    "AS", "BS", "CS", "ES", "FS", "GS1000", "LOG1000", "N0_ICL_SED",
    "RHO_I_ICL",
)


def _logistic_consts(pp, eps: float):
    """Host side of ``ops.common.logistic_function_integral``:
    ``(x0_safe, k, translation, x0 < eps)``."""
    x0 = float(torch.tensor(pp.q_threshold, dtype=torch.float32))
    k = pp.k
    # trnslt = -log1mexp(-k) / k
    log1mexp = (math.log(-math.expm1(-k)) if -k > -math.log(2.0)
                else math.log1p(-math.exp(-k)))
    return max(x0, eps), k, -log1mexp / k, float(x0 < eps)


def _param_values(mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                  tv: TerminalVelocityParams) -> dict:
    """Every float the kernel reads, keyed by :data:`PARAM_NAMES`; the
    products and logs the eager code folds from Python floats are folded
    here the same way, in float64."""
    f32 = torch.float32
    eps = eps_numerics(f32)
    tiny = 1e-25
    pi = math.pi
    aps = mp.air_properties
    rain, snow, ice = mp.precip.rain, mp.precip.snow, mp.cloud.ice
    vr, vs = mp.terminal_velocity.rain, mp.terminal_velocity.snow
    pp = mp.process_params
    small_ice = tv.chen2022.small_ice
    stokes = tv.stokes

    v = dict(
        EPS=eps, TINY=tiny, LOG_EPS=math.log(eps),
        HALF_MIN=torch.finfo(f32).min / 2,
        LOG_TINY=math.log(torch.finfo(f32).tiny),
        T_0=tps.T_0, LH_V0=tps.LH_v0, LH_S0=tps.LH_s0, LH_F0=tps.LH_f0,
        DCP_VL=tps.cp_v - tps.cp_l, DCP_VI=tps.cp_v - tps.cp_i,
        DCP_LI=tps.cp_l - tps.cp_i,
        CP_D=tps.cp_d, CPVD=tps.cp_v - tps.cp_d, CPLV=tps.cp_l - tps.cp_v,
        CPIV=tps.cp_i - tps.cp_v, CV_L=tps.cv_l,
        T_TRIPLE=tps.T_triple, INV_T_TRIPLE=1 / tps.T_triple,
        PRESS_TRIPLE=tps.press_triple,
        KV_L=(tps.cp_v - tps.cp_l) / tps.R_v,
        CL_L=(tps.LH_v0 - (tps.cp_v - tps.cp_l) * tps.T_0) / tps.R_v,
        KV_I=(tps.cp_v - tps.cp_i) / tps.R_v,
        CL_I=(tps.LH_s0 - (tps.cp_v - tps.cp_i) * tps.T_0) / tps.R_v,
        R_V=tps.R_v, T_FREEZE=tps.T_freeze,
        K_THERM=aps.K_therm, K_THERM_SAFE=max(aps.K_therm, eps),
        D_VAPOR_SAFE=max(aps.D_vapor, eps), NU_AIR=aps.nu_air,
        LOG_MU_SNO=math.log(snow.pdf.mu), NU_SNO=snow.pdf.nu,
        N0_RAI=rain.pdf.n0, N0_ICL=ice.pdf.n0,
        V0C_RAI=(8.0 / 3.0) / vr.C_drag, RHO_W_VEL_RAI=vr.rho_w,
        GRAV_VEL_RAI=vr.grav, R0_VEL_RAI=vr.r0,
        TAU_LCL=pp.cloud_liquid_formation.tau_relax,
        TAU_ICL=pp.cloud_ice_formation.tau_relax,
        E_LR=pp.cloud_liquid_rain_accretion.e,
        E_LS=pp.cloud_liquid_snow_accretion.e,
        E_IR=pp.cloud_ice_rain_accretion.e,
        E_IS=pp.cloud_ice_snow_accretion.e,
        E_RS=pp.rain_snow_accretion.e, CD_RS=pp.rain_snow_accretion.coeff_disp,
        A0_RAI=rain.area.a0, CHIA_RAI=rain.area.chia, CHIV_RAI=vr.chiv,
        GACC_RAI=vr.gamma_accr,
        PACC_RAI=rain.area.ae + vr.ve + rain.area.da + vr.dv,
        A0_SNO=snow.area.a0, V0_SNO=vs.v0, CHIA_SNO=snow.area.chia,
        CHIV_SNO=vs.chiv, GACC_SNO=vs.gamma_accr,
        PACC_SNO=snow.area.ae + vs.ve + snow.area.da + vs.dv,
        M0_RAI=rain.mass.m0, CHIM_RAI=rain.mass.chim,
        GSINK_RAI=vr.gamma_accr_rain_sink,
        PSINK_RAI=(rain.mass.me + rain.area.ae + vr.ve + rain.mass.dm
                   + rain.area.da + vr.dv),
        PVT_RAI=vr.ve + vr.dv, GTERM_RAI=vr.gamma_term,
        GC_RAI=rain.mass.gamma_coeff,
        CV0_SNO=vs.chiv * vs.v0, PVT_SNO=vs.ve + vs.dv,
        GTERM_SNO=vs.gamma_term, GC_SNO=snow.mass.gamma_coeff,
        PI=pi, M0_SNO=snow.mass.m0, CHIM_SNO=snow.mass.chim,
        PI4=4 * pi, C4PI_N0_RAI=4 * pi * rain.pdf.n0,
        C4PI_N0_ICL=4 * pi * ice.pdf.n0,
        C18=1.0 / 18.0, RHO_W_STOKES=stokes.rho_w, GRAV_STOKES=stokes.grav,
        NU_STOKES=stokes.nu_air, C6PI=6 / pi, C23=2.0 / 3.0,
        N0_LCL=mp.cloud.liquid.N_0, RHO_W_LCL=mp.cloud.liquid.rho_w,
        LOG1000=math.log(1000.0), N0_ICL_SED=ice.N_0, RHO_I_ICL=ice.rho_i,
    )

    # lambda_inv of rain, snow, cloud ice (ops/m1.py:_log_lambda_inverse)
    for tag, species in (("RAI", rain), ("SNO", snow), ("ICL", ice)):
        m = species.mass
        v[f"POW_{tag}"] = 1.0 / (m.me + m.dm + 1)
        v[f"LOGNUM_{tag}"] = math.log(m.r0) * (m.me + m.dm)
        v[f"LOGFLOOR_{tag}"] = math.log(m.r0 * 1e-5)
        logc = math.log(m.chim * m.m0 * m.gamma_coeff)
        if tag == "SNO":
            v["LOGC_SNO"] = logc
        else:
            v[f"LOGDEN_{tag}"] = logc + math.log(max(species.pdf.n0, eps))
    v["LOG_R0_RAI"] = math.log(rain.mass.r0)
    v["LOG_R0_SNO"] = math.log(snow.mass.r0)

    # rain-snow collisions: powers of the collected species' lambda
    for tag, species in (("RAI", rain), ("SNO", snow)):
        delta = species.mass.me + species.mass.dm
        v[f"R0D_{tag}"] = species.mass.r0 ** delta
        v[f"EXP1_{tag}"] = delta + 1
        v[f"EXP2_{tag}"] = delta + 2
        v[f"EXP3_{tag}"] = delta + 3
        v[f"C2_{tag}"] = 2 * (delta + 1)
        v[f"C3_{tag}"] = (delta + 2) * (delta + 1)

    # ventilation brackets (ops/m1.py:_ventilated_lambda_term)
    sc_cbrt = (aps.nu_air / max(aps.D_vapor, eps)) ** (1.0 / 3.0)
    for tag, species, vel in (("RAI", rain, vr), ("SNO", snow, vs)):
        v[f"VA_{tag}"] = species.vent.a
        v[f"VBSC_{tag}"] = species.vent.b * sc_cbrt
        v[f"PVENT_{tag}"] = (vel.ve + vel.dv) / 2
        v[f"GVENT_{tag}"] = vel.gamma_vent
    v["SQ_SNO"] = 2 * vs.v0 * vs.chiv / aps.nu_air

    for tag, opt in (("R", pp.rain_autoconversion),
                     ("S", pp.snow_autoconversion)):
        x0s, k, trn, x0lt = _logistic_consts(opt, eps)
        v.update({f"ACNV_{tag}_X0S": x0s, f"ACNV_{tag}_K": k,
                  f"ACNV_{tag}_TRN": trn, f"ACNV_{tag}_X0LT": x0lt,
                  f"ACNV_{tag}_TAU": opt.tau})

    # Chen 2022 small-ice coefficients (ops/common.py), all of rho_i
    A, B, C = small_ice.A, small_ice.B, small_ice.C
    E, F, G = small_ice.E, small_ice.F, small_ice.G
    rho_i = ice.rho_i
    log_r, sqrt_r = math.log(rho_i), math.sqrt(rho_i)
    v["AS"] = A[1] * log_r**2 - A[2] * log_r + A[0]
    v["BS"] = 1 / (B[0] + B[1] * log_r + B[2] / sqrt_r)
    v["CS"] = C[0] + C[1] * math.exp(C[2] * rho_i) + C[3] * sqrt_r
    v["ES"] = E[0] - E[1] * log_r**2 + E[2] * sqrt_r
    v["FS"] = -math.exp(F[0] - F[1] * log_r**2 + F[2] * log_r)
    v["GS1000"] = 1 / (G[0] + G[1] / log_r - G[2] * log_r / rho_i) * 1000.0
    return v


def kernel_params(mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                  tv: TerminalVelocityParams,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """The kernel's float32 parameter buffer, in :data:`PARAM_NAMES` order."""
    values = _param_values(mp, tps, tv)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    return torch.tensor([values[n] for n in PARAM_NAMES], dtype=torch.float64,
                        device=device).to(torch.float32)


# ---------------------------------------------------------------------------
# Packed state
# ---------------------------------------------------------------------------

def pack_state(state: ColumnState) -> torch.Tensor:
    """Stack the 7 prognostic fields into one ``(7, ncol, nlev)`` buffer
    (structure of arrays): one read and one write stream per step."""
    return torch.stack(list(state), dim=0)


def unpack_state(packed: torch.Tensor) -> ColumnState:
    """Inverse of :func:`pack_state` (views into ``packed``)."""
    return ColumnState(*packed.unbind(0))


# ---------------------------------------------------------------------------
# Plain versions (eager PyTorch): the CPU path and the kernels' reference
# ---------------------------------------------------------------------------

def step_column_1m_plain(state: ColumnState, mp, tps, tv, dt, dz,
                         mode: str = "instantaneous", nsub: int = 1,
                         sediment_cloud: bool = True,
                         q_tot_affine=None) -> ColumnState:
    """What :func:`step_column_1m_fused` computes, in eager PyTorch."""
    if q_tot_affine is not None:
        scale, bias = q_tot_affine
        state = state._replace(q_tot=state.q_tot * scale + bias)
    return step_column_1m(state, mp, tps, tv, dt, dz, mode=mode, nsub=nsub,
                          sediment_cloud=sediment_cloud)


def step_column_1m_packed_plain(packed: torch.Tensor, mp, tps, tv, dt, dz,
                                mode: str = "instantaneous", nsub: int = 1,
                                sediment_cloud: bool = True,
                                q_tot_affine=None) -> torch.Tensor:
    """What :func:`step_column_1m_fused_packed` computes, in eager
    PyTorch: unpack, step, pack."""
    return pack_state(step_column_1m_plain(
        unpack_state(packed), mp, tps, tv, dt, dz, mode=mode, nsub=nsub,
        sediment_cloud=sediment_cloud, q_tot_affine=q_tot_affine))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _library() -> ctypes.CDLL:
    header = _build.index_header(PARAM_NAMES, "COLUMN1M_PARAMS_H")
    lib = _build.load("column1m.cu", "column1m_params.h", header)
    if not getattr(lib, "_signatures_set", False):
        tail = [_P, _I, _I, _I, _F, _F, _I, _I, _F, _F, _I, _P]
        lib.column1m_step_unpacked.argtypes = [_P] * 14 + tail
        lib.column1m_step_unpacked.restype = _I
        lib.column1m_step_packed.argtypes = [_P, _P, ctypes.c_longlong] + tail
        lib.column1m_step_packed.restype = _I
        lib.column1m_num_params.restype = _I
        lib.column1m_threads_per_block.restype = _I
        if lib.column1m_num_params() != len(PARAM_NAMES):
            raise RuntimeError("column1m library built from another "
                               "parameter list")
        if lib.column1m_threads_per_block() != MAX_NLEV:
            raise RuntimeError("column1m library built with another block "
                               "size")
        lib._signatures_set = True
    return lib


def _check_supported(mp, mode: str, nlev: int, dtype: torch.dtype) -> None:
    if mode != "instantaneous":
        raise NotImplementedError(
            f"the CUDA 1M column kernel supports mode='instantaneous', "
            f"not {mode!r}")
    if mp.processes != Microphysics1MOptions():
        raise NotImplementedError(
            "the CUDA 1M column kernel supports the default "
            "Microphysics1MOptions only")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA 1M column kernel supports float32, not {dtype}")
    if nlev > MAX_NLEV:
        raise NotImplementedError(
            f"the CUDA 1M column kernel supports nlev <= {MAX_NLEV}, "
            f"got {nlev}")


def _check_tiling(ncol: int, block_cols: int) -> None:
    if block_cols < 1 or ncol % block_cols:
        raise ValueError(
            f"ncol={ncol} not a multiple of block_cols={block_cols}")


def _device_params(params, mp, tps, tv, device) -> torch.Tensor:
    if params is None:
        return kernel_params(mp, tps, tv, device=device)
    if (params.device != device or params.dtype != torch.float32
            or params.shape != (len(PARAM_NAMES),)
            or not params.is_contiguous()):
        raise ValueError(
            f"params must be a contiguous float32 ({len(PARAM_NAMES)},) "
            f"tensor on {device}")
    return params


def _check_cuda(tensors, where: str) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise NotImplementedError(
            f"{where}: no kernel for device type {device.type!r}")
    for t in tensors:
        if t.device != device or t.dtype != tensors[0].dtype:
            raise ValueError(f"{where}: fields differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{where}: fields must be contiguous")
    return device


def _affine(q_tot_affine):
    if q_tot_affine is None:
        return 0, 0.0, 0.0
    scale, bias = q_tot_affine
    return 1, float(scale), float(bias)


def step_column_1m_fused(state: ColumnState, mp, tps, tv, dt, dz,
                         mode: str = "instantaneous", nsub: int = 1,
                         sediment_cloud: bool = True,
                         block_cols: int = 256,
                         q_tot_affine=None, params=None) -> ColumnState:
    """One fused 1M column step on seven ``(ncol, nlev)`` fields.

    ``ncol`` must be a multiple of ``block_cols`` (the columns one thread
    block steps). ``q_tot_affine``: optional ``(scale, bias)`` applied to
    ``q_tot`` on load (``q_tot*scale + bias``). ``params``: the buffer of
    :func:`kernel_params`, built here when not given. CPU tensors take
    :func:`step_column_1m_plain`.
    """
    ncol, nlev = state.rho.shape
    _check_tiling(ncol, block_cols)
    for t in state:
        if t.shape != (ncol, nlev):
            raise ValueError(f"every field must be {(ncol, nlev)}, "
                             f"got {tuple(t.shape)}")
    if state.rho.device.type == "cpu":
        return step_column_1m_plain(state, mp, tps, tv, dt, dz, mode=mode,
                                    nsub=nsub, sediment_cloud=sediment_cloud,
                                    q_tot_affine=q_tot_affine)
    device = _check_cuda(list(state), "step_column_1m_fused")
    _check_supported(mp, mode, nlev, state.rho.dtype)
    params = _device_params(params, mp, tps, tv, device)
    lib = _library()
    out = ColumnState(*(torch.empty_like(t) for t in state))
    has_affine, scale, bias = _affine(q_tot_affine)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.column1m_step_unpacked(
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in out),
        params.data_ptr(), ncol, nlev, block_cols, float(dt), float(dz),
        int(bool(sediment_cloud)), has_affine, scale, bias, device.index,
        stream)
    if err:
        raise RuntimeError(f"column1m_step_unpacked launch failed: CUDA "
                           f"error {err}")
    step_column_1m_fused.launches += 1
    return out


step_column_1m_fused.launches = 0


def step_column_1m_fused_packed(packed: torch.Tensor, mp, tps, tv, dt, dz,
                                mode: str = "instantaneous", nsub: int = 1,
                                sediment_cloud: bool = True,
                                block_cols: int = 128,
                                q_tot_affine=None,
                                params=None) -> torch.Tensor:
    """Packed-state variant of :func:`step_column_1m_fused`: the state is
    one ``(7, ncol, nlev)`` tensor (see :func:`pack_state`) and maps to a
    like-shaped output. CPU tensors take
    :func:`step_column_1m_packed_plain`."""
    if packed.dim() != 3 or packed.shape[0] != len(_FIELDS):
        raise ValueError(f"packed state must be (7, ncol, nlev), got "
                         f"{tuple(packed.shape)}")
    _, ncol, nlev = packed.shape
    _check_tiling(ncol, block_cols)
    if packed.device.type == "cpu":
        return step_column_1m_packed_plain(
            packed, mp, tps, tv, dt, dz, mode=mode, nsub=nsub,
            sediment_cloud=sediment_cloud, q_tot_affine=q_tot_affine)
    device = _check_cuda([packed], "step_column_1m_fused_packed")
    _check_supported(mp, mode, nlev, packed.dtype)
    params = _device_params(params, mp, tps, tv, device)
    lib = _library()
    out = torch.empty_like(packed)
    has_affine, scale, bias = _affine(q_tot_affine)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.column1m_step_packed(
        packed.data_ptr(), out.data_ptr(), ncol * nlev,
        params.data_ptr(), ncol, nlev, block_cols, float(dt), float(dz),
        int(bool(sediment_cloud)), has_affine, scale, bias, device.index,
        stream)
    if err:
        raise RuntimeError(f"column1m_step_packed launch failed: CUDA "
                           f"error {err}")
    step_column_1m_fused_packed.launches += 1
    return out


step_column_1m_fused_packed.launches = 0
