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
:func:`step_column_1m_packed_plain`). A CUDA tensor launches the kernel in
the whole scope of :func:`..models.column.step_column_1m`: both modes
(``"instantaneous"``, and ``"linearized_average"`` with ``nsub`` substeps),
every :class:`~..parameters.m1.Microphysics1MOptions` selection, float32 and
float64, any number of levels (a warp steps a column, so the layout has no
bound of its own). It raises only for an unknown mode, ``nsub < 1`` in
``"linearized_average"`` (``ValueError``) and another dtype
(``NotImplementedError``); ``"instantaneous"`` ignores ``nsub``, as the
eager step does.

The kernel's parameters, scalar type, mode and options are compiled into
it. :func:`kernel_params` builds the parameter block of a dtype on the host
(its values in float64, with the dtype's own thresholds; a process option
not selected leaves its values 0), and the build writes each value as an
exact literal of that dtype into the generated header (:func:`header`),
with the mode and one macro per option slot (:func:`variant`). So the
library is built once per parameter block, dtype, mode and option set (at
its first launch, cached on disk by the header's hash), branches on an
option are decided when it is compiled, and every constant is an immediate
operand. The wrappers read the block on the host, never from the device,
which would add a synchronising copy to every step. :data:`PARAM_NAMES`
is the only definition of the block's order, one list for every variant.

On a CUDA tensor a wrapper's preparation (the checks, the parameter
block, the library, the outputs) is the span ``column.prepare`` and its
launch the span ``launch.k1``; each launch adds one to the counter
``launches.<wrapper>`` (:mod:`..trace`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import trace
from ..models.column import ColumnState, step_column_1m
from ..parameters import m1 as P1
from ..parameters.m1 import Microphysics1MParams
from ..parameters.terminal_velocity import TerminalVelocityParams
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import eps_numerics, machine_eps
from . import _build

__all__ = [
    "MODES",
    "OPTION_CODES",
    "PARAM_NAMES",
    "kernel_params",
    "pack_state",
    "step_column_1m_fused",
    "step_column_1m_fused_packed",
    "step_column_1m_packed_plain",
    "step_column_1m_plain",
    "unpack_state",
    "variant",
]

_FIELDS = ColumnState._fields  # (rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno)

# Columns a thread block steps by default (8 warps, 4 columns each): at
# 524288 x 128 on an H100 the grid's last, part-empty wave of blocks costs
# less than with 128 (PERF.md).
BLOCK_COLS = 32

PARAM_NAMES = (
    # constants of the dtype
    "EPS", "TINY", "LOG_EPS", "HALF_MIN", "LOG_TINY", "EPS_MACH",
    # thermodynamics
    "T_0", "LH_V0", "LH_S0", "LH_F0", "DCP_VL", "DCP_VI", "DCP_LI",
    "CP_D", "CPVD", "CPLV", "CPIV", "CV_L", "INV_T_TRIPLE",
    "PRESS_TRIPLE", "KV_L", "CL_L", "KV_I", "CL_I", "R_V", "INV_R_V",
    "T_FREEZE",
    # air
    "K_THERM", "INV_K_THERM_SAFE", "INV_D_VAPOR_SAFE", "INV_NU_AIR",
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
    "ACNV_R_X0S", "ACNV_R_K", "ACNV_R_X0LT", "INV_ACNV_R_TAU",
    "ACNV_S_X0S", "ACNV_S_K", "ACNV_S_X0LT", "INV_ACNV_S_TAU",
    # accretion
    "E_LR", "E_LS", "E_IR", "E_IS", "E_RS", "CD_RS",
    "A0_RAI", "CHIA_RAI", "CHIV_RAI", "GACC_RAI", "PACC_RAI",
    "A0_SNO", "V0_SNO", "CHIA_SNO", "CHIV_SNO", "GACC_SNO", "PACC_SNO",
    "M0_RAI", "CHIM_RAI", "GSINK_RAI", "PSINK_RAI",
    # bulk terminal velocities
    "PVT_RAI", "GTERM_RAI", "GC_RAI", "INV_GC_RAI", "CV0_SNO", "PVT_SNO",
    "GTERM_SNO", "GC_SNO", "INV_GC_SNO",
    # rain-snow collisions
    "PI", "M0_SNO", "CHIM_SNO", "INV_R0D_RAI", "INV_R0D_SNO",
    "EXP1_RAI", "EXP2_RAI", "EXP3_RAI", "C2_RAI", "C3_RAI",
    "EXP1_SNO", "EXP2_SNO", "EXP3_SNO", "C2_SNO", "C3_SNO",
    # evaporation, sublimation, melt
    "VA_RAI", "VBSC_RAI", "PVENT_RAI", "GVENT_RAI", "C4PI_N0_RAI",
    "VA_SNO", "VBSC_SNO", "PVENT_SNO", "GVENT_SNO", "SQ_SNO", "PI4",
    "C4PI_N0_ICL",
    # cloud sedimentation: Stokes liquid, Chen 2022 small ice
    "C18", "RHO_W_STOKES", "GRAV_STOKES", "INV_NU_STOKES", "C6PI", "C23",
    "INV_N0_LCL", "INV_RHO_W_LCL",
    "AS", "BS", "CS", "ES", "FS", "GS1000", "LOG1000", "INV_N0_ICL_SED",
    "INV_RHO_I_ICL",
    # linearized_average: the donor floor, the substeps' constant heats
    "Q_MIN", "LV_OVER_CP", "LS_OVER_CP",
    # TemperatureDependent cloud ice formation (Frostenberg 2023 INP)
    "FR_T_FREEZE", "FR_NEG_B", "INV_TEN", "FR_LOG_A", "RHO_I_ICL", "FR_R_MIN",
    "C4PI_DV",
    # PrescribedNd rain autoconversion: 1 / (tau (Nc / 1e8)^alpha)
    "INV_ACNV_PND",
    # WithSupersaturation snow autoconversion
    "NEG_R_IS", "R_IS", "R_IS2_DELTA",
)

# The tendency modes the column step takes (models/tendencies.py; the
# column step has no use for instantaneous_verbose's source terms).
MODES = ("instantaneous", "linearized_average")

# Each Microphysics1MOptions slot's options and their build codes: 0 for a
# disabled process (None), 1 for the default option, 2 for the alternative.
OPTION_CODES = {
    "cloud_liquid_formation": (P1.CLOUD_LIQUID_FORMATION,),
    "cloud_ice_formation": (P1.CONSTANT_TIMESCALE, P1.TEMPERATURE_DEPENDENT),
    "cloud_ice_melt": (P1.CLOUD_ICE_MELT,),
    "rain_autoconversion": (P1.KESSLER_1M, P1.PRESCRIBED_ND),
    "snow_autoconversion": (P1.NO_SUPERSATURATION, P1.WITH_SUPERSATURATION),
    "rain_condensation_evaporation": (P1.RAIN_EVAPORATION,),
    "snow_deposition_sublimation": (P1.DEPOSITION_AND_SUBLIMATION,
                                    P1.SUBLIMATION_ONLY),
    "snow_melt": (P1.SNOW_MELT,),
    "cloud_liquid_rain_accretion": (P1.CLOUD_LIQUID_RAIN_ACCRETION,),
    "cloud_liquid_snow_accretion": (P1.CLOUD_LIQUID_SNOW_ACCRETION,),
    "cloud_ice_rain_accretion": (P1.CLOUD_ICE_RAIN_ACCRETION,),
    "cloud_ice_snow_accretion": (P1.CLOUD_ICE_SNOW_ACCRETION,),
    "rain_snow_accretion": (P1.RAIN_SNOW_ACCRETION,),
}


def variant(mp: Microphysics1MParams, mode: str = "instantaneous") -> tuple:
    """The build variant of a parameter set and mode: ``(linearized, code of
    each option slot in OPTION_CODES order)``. An option the kernel does not
    know raises ``ValueError``, as the eager step does."""
    codes = []
    for slot, options in OPTION_CODES.items():
        option = getattr(mp.processes, slot)
        if option is not None and option not in options:
            raise ValueError(f"unknown {slot} option {option!r}")
        codes.append(0 if option is None else 1 + options.index(option))
    return (int(mode == "linearized_average"), *codes)


def _logistic_consts(pp, eps: float, dtype: torch.dtype):
    """Host side of ``ops.common.logistic_function_integral``:
    ``(x0_safe, k, x0 < eps)`` with x0 in ``dtype``, as the eager step holds
    it; the kernel takes the translation from k as the eager step does."""
    x0 = float(torch.tensor(pp.q_threshold, dtype=dtype))
    return max(x0, eps), pp.k, float(x0 < eps)


def _param_values(mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                  tv: TerminalVelocityParams,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Every value the kernel reads, keyed by :data:`PARAM_NAMES`, with the
    thresholds of ``dtype``; the products and logs the eager code folds from
    Python floats are folded here the same way, in float64. ``INV_<x>`` is
    ``1/x`` in float64: where the eager step divides a tensor by a Python
    float, PyTorch's CUDA kernel multiplies by that reciprocal rounded once
    to the tensor's dtype, and so does the kernel. The values of an option
    slot that is not selected are 0 (the build does not read them)."""
    eps = eps_numerics(dtype)
    tiny = 1e-50 if dtype == torch.float64 else 1e-25
    pi = math.pi
    aps = mp.air_properties
    rain, snow, ice = mp.precip.rain, mp.precip.snow, mp.cloud.ice
    vr, vs = mp.terminal_velocity.rain, mp.terminal_velocity.snow
    pp = mp.process_params
    small_ice = tv.chen2022.small_ice
    stokes = tv.stokes

    opts = mp.processes

    def param(slot, attr):
        pp_slot = getattr(pp, slot)
        return 0.0 if pp_slot is None else getattr(pp_slot, attr)

    v = dict(
        EPS=eps, TINY=tiny, LOG_EPS=math.log(eps),
        HALF_MIN=torch.finfo(dtype).min / 2,
        LOG_TINY=math.log(torch.finfo(dtype).tiny), EPS_MACH=machine_eps(dtype),
        T_0=tps.T_0, LH_V0=tps.LH_v0, LH_S0=tps.LH_s0, LH_F0=tps.LH_f0,
        DCP_VL=tps.cp_v - tps.cp_l, DCP_VI=tps.cp_v - tps.cp_i,
        DCP_LI=tps.cp_l - tps.cp_i,
        CP_D=tps.cp_d, CPVD=tps.cp_v - tps.cp_d, CPLV=tps.cp_l - tps.cp_v,
        CPIV=tps.cp_i - tps.cp_v, CV_L=tps.cv_l,
        INV_T_TRIPLE=1 / tps.T_triple,
        PRESS_TRIPLE=tps.press_triple,
        KV_L=(tps.cp_v - tps.cp_l) / tps.R_v,
        CL_L=(tps.LH_v0 - (tps.cp_v - tps.cp_l) * tps.T_0) / tps.R_v,
        KV_I=(tps.cp_v - tps.cp_i) / tps.R_v,
        CL_I=(tps.LH_s0 - (tps.cp_v - tps.cp_i) * tps.T_0) / tps.R_v,
        R_V=tps.R_v, INV_R_V=1 / tps.R_v, T_FREEZE=tps.T_freeze,
        K_THERM=aps.K_therm, INV_K_THERM_SAFE=1 / max(aps.K_therm, eps),
        INV_D_VAPOR_SAFE=1 / max(aps.D_vapor, eps),
        INV_NU_AIR=1 / aps.nu_air,
        LOG_MU_SNO=math.log(snow.pdf.mu), NU_SNO=snow.pdf.nu,
        N0_RAI=rain.pdf.n0, N0_ICL=ice.pdf.n0,
        V0C_RAI=(8.0 / 3.0) / vr.C_drag, RHO_W_VEL_RAI=vr.rho_w,
        GRAV_VEL_RAI=vr.grav, R0_VEL_RAI=vr.r0,
        TAU_LCL=param("cloud_liquid_formation", "tau_relax"),
        TAU_ICL=param("cloud_ice_formation", "tau_relax"),
        E_LR=param("cloud_liquid_rain_accretion", "e"),
        E_LS=param("cloud_liquid_snow_accretion", "e"),
        E_IR=param("cloud_ice_rain_accretion", "e"),
        E_IS=param("cloud_ice_snow_accretion", "e"),
        E_RS=param("rain_snow_accretion", "e"),
        CD_RS=param("rain_snow_accretion", "coeff_disp"),
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
        GC_RAI=rain.mass.gamma_coeff, INV_GC_RAI=1 / rain.mass.gamma_coeff,
        CV0_SNO=vs.chiv * vs.v0, PVT_SNO=vs.ve + vs.dv,
        GTERM_SNO=vs.gamma_term, GC_SNO=snow.mass.gamma_coeff,
        INV_GC_SNO=1 / snow.mass.gamma_coeff,
        PI=pi, M0_SNO=snow.mass.m0, CHIM_SNO=snow.mass.chim,
        PI4=4 * pi, C4PI_N0_RAI=4 * pi * rain.pdf.n0,
        C4PI_N0_ICL=4 * pi * ice.pdf.n0,
        C18=1.0 / 18.0, RHO_W_STOKES=stokes.rho_w, GRAV_STOKES=stokes.grav,
        INV_NU_STOKES=1 / stokes.nu_air, C6PI=6 / pi, C23=2.0 / 3.0,
        INV_N0_LCL=1 / mp.cloud.liquid.N_0,
        INV_RHO_W_LCL=1 / mp.cloud.liquid.rho_w,
        LOG1000=math.log(1000.0), INV_N0_ICL_SED=1 / ice.N_0,
        INV_RHO_I_ICL=1 / ice.rho_i,
        Q_MIN=tps.q_min, LV_OVER_CP=tps.LH_v0 / tps.cp_d,
        LS_OVER_CP=tps.LH_s0 / tps.cp_d,
    )
    # the alternative options' values (ops/noneq.py:tau_relax_frostenberg,
    # ops/m1.py:conv_q_lcl_to_q_rai, conv_q_icl_to_q_sno), 0 when another
    # option is selected
    fr = (pp.cloud_ice_formation.frostenberg
          if opts.cloud_ice_formation == P1.TEMPERATURE_DEPENDENT else None)
    v.update(FR_T_FREEZE=fr.T_freeze if fr else 0.0,
             FR_NEG_B=-fr.b if fr else 0.0, INV_TEN=1 / 10,
             FR_LOG_A=fr.log_a if fr else 0.0, RHO_I_ICL=ice.rho_i,
             FR_R_MIN=1e-6, C4PI_DV=4 * pi * aps.D_vapor)
    pnd = (pp.rain_autoconversion
           if opts.rain_autoconversion == P1.PRESCRIBED_ND else None)
    v["INV_ACNV_PND"] = (1 / (pnd.tau * (pnd.Nc / 1e8) ** pnd.alpha)
                         if pnd else 0.0)
    r_is = (pp.snow_autoconversion.r_ice_snow
            if opts.snow_autoconversion == P1.WITH_SUPERSATURATION else 0.0)
    v.update(NEG_R_IS=-r_is, R_IS=r_is,
             R_IS2_DELTA=r_is**2 / (ice.mass.me + ice.mass.dm))

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
        v[f"INV_R0D_{tag}"] = 1 / species.mass.r0 ** delta
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

    # the logistic (Kessler1M, NoSupersaturation) autoconversions
    for tag, slot, logistic in (
            ("R", "rain_autoconversion", P1.KESSLER_1M),
            ("S", "snow_autoconversion", P1.NO_SUPERSATURATION)):
        if getattr(opts, slot) == logistic:
            opt = getattr(pp, slot)
            x0s, k, x0lt = _logistic_consts(opt, eps, dtype)
            inv_tau = 1 / opt.tau
        else:
            x0s = k = x0lt = inv_tau = 0.0
        v.update({f"ACNV_{tag}_X0S": x0s, f"ACNV_{tag}_K": k,
                  f"ACNV_{tag}_X0LT": x0lt, f"INV_ACNV_{tag}_TAU": inv_tau})

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


@trace.timed("setup.params_s")
def kernel_params(mp: Microphysics1MParams, tps: ThermodynamicsParameters,
                  tv: TerminalVelocityParams,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's parameter block for ``dtype`` (float32 or float64), in
    :data:`PARAM_NAMES` order, on the host (a CPU tensor of that dtype): the
    kernel is built for its values."""
    _build.check_dtype(dtype, "1M")
    values = _param_values(mp, tps, tv, dtype)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    return torch.tensor([values[n] for n in PARAM_NAMES],
                        dtype=torch.float64).to(dtype)


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


SOURCE = "column1m.cu"
# nvcc flags of each build of the source: the one the wrappers launch
# (-lineinfo leaves the code as it is and maps each SASS instruction to its
# source line, which kernels/opcount.py reads) and the stage-timing probe
BUILDS = {
    "kernel": ("-lineinfo",),
    "probe": ("-lineinfo", "-DK1_PROBE"),
}
# the stages the probe build times, in the order of enum ProbeStage
PROBE_STAGES = ("load", "cell", "exchange", "store")
# the variant of the default options in mode "instantaneous"
DEFAULT_VARIANT = (0,) + (1,) * len(OPTION_CODES)


def header(params: torch.Tensor, variant=DEFAULT_VARIANT) -> str:
    """The generated header of a parameter block (float32 or float64) and a
    build :func:`variant`: ``#define PC_<name>`` as a hexadecimal literal of
    each value in the block's dtype (exact), in :data:`PARAM_NAMES` order,
    ``K1_REAL`` (the scalar type), ``K1_LINEARIZED``, ``K1_OPT_<SLOT>`` for
    each option slot and ``N_PARAMS``."""
    linearized, *codes = variant
    if len(codes) != len(OPTION_CODES) or linearized not in (0, 1) or any(
            c not in range(len(o) + 1)
            for c, o in zip(codes, OPTION_CODES.values())):
        raise ValueError(f"not a variant of the 1M kernel: {variant}")
    defines = [("K1_REAL", _build.c_type(params.dtype)),
               ("K1_LINEARIZED", int(linearized))]
    defines += [(f"K1_OPT_{slot.upper()}", int(c))
                for slot, c in zip(OPTION_CODES, codes)]
    return _build.literal_header("column1m", PARAM_NAMES, params, defines)


def library_path(params: torch.Tensor, build: str = "kernel",
                 variant=DEFAULT_VARIANT):
    """The file of one of the kernel library's :data:`BUILDS` for the
    parameter block ``params`` and ``variant`` (built if needed)."""
    return _build.build(SOURCE, "column1m_params.h", header(params, variant),
                        BUILDS[build] + _build.dtype_flags(params.dtype))


def _library(params: torch.Tensor, build: str = "kernel",
             variant=DEFAULT_VARIANT) -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS` for the parameter block
    ``params`` and ``variant``, loaded and bound (:func:`_build.library`)."""
    return _build.library(
        SOURCE, build, variant, lambda: library_path(params, build, variant),
        lambda lib: bind(lib, build == "probe", params.dtype, variant),
        block=params)


def bind(lib: ctypes.CDLL, probe: bool = False,
         dtype: torch.dtype = torch.float32,
         variant=DEFAULT_VARIANT) -> ctypes.CDLL:
    """Set the C signatures of a loaded build of the source for ``dtype``
    and ``variant`` (``probe``: the ``-DK1_PROBE`` one) and check it against
    this module; returns it."""
    _R = _build.c_scalar(dtype)
    tail = [_I, _I, _I, _R, _R, _I, _I, _R, _R, _I, _R, _R, _R, _I, _P]
    lib.column1m_step_unpacked.argtypes = [_P] * 14 + tail
    lib.column1m_step_unpacked.restype = _I
    lib.column1m_step_packed.argtypes = [_P, _P, ctypes.c_longlong] + tail
    lib.column1m_step_packed.restype = _I
    lib.column1m_num_params.restype = _I
    lib.column1m_real_bytes.restype = _I
    lib.column1m_variant.restype = ctypes.c_longlong
    lib.column1m_threads_per_block.restype = _I
    lib.column1m_blocks_per_sm.argtypes = [_I, _P]
    lib.column1m_blocks_per_sm.restype = _I
    lib.column1m_kernel_attrs.argtypes = [_P, _P]
    lib.column1m_kernel_attrs.restype = _I
    if probe:
        lib.column1m_probe_set.argtypes = [_P, _I]
        lib.column1m_probe_set.restype = _I
        lib.column1m_probe_stages.restype = _I
        if lib.column1m_probe_stages() != len(PROBE_STAGES):
            raise RuntimeError("column1m probe built with another "
                               "stage list")
    if lib.column1m_num_params() != len(PARAM_NAMES):
        raise RuntimeError("column1m library built from another "
                           "parameter list")
    if lib.column1m_real_bytes() != dtype.itemsize:
        raise RuntimeError(f"column1m library built for another dtype "
                           f"than {dtype}")
    if lib.column1m_variant() != int("".join(map(str, variant))):
        raise RuntimeError(f"column1m library built for another variant "
                           f"than {tuple(variant)}")
    return lib


def _check_supported(mp, mode: str, nlev: int, dtype: torch.dtype,
                     nsub: int = 1) -> None:
    """Raise for what the kernel cannot step: an unknown mode or option and
    ``nsub < 1`` (``ValueError``, as the eager step), a dtype other than
    float32 and float64 (``NotImplementedError``), no levels."""
    if mode not in MODES:
        raise ValueError(f"unknown tendency mode {mode!r} for the CUDA 1M "
                         f"column kernel (it steps {MODES})")
    if mode == "linearized_average" and int(nsub) < 1:
        raise ValueError(f"linearized_average needs nsub >= 1, got {nsub}")
    _build.check_dtype(dtype, "1M")
    if nlev < 1:
        raise ValueError(f"the CUDA 1M column kernel needs nlev >= 1, got "
                         f"{nlev}")
    variant(mp, mode)


def host_params(params, mp, tps, tv,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The parameter block a launch's library is built for: ``params``
    itself (the block of :func:`kernel_params` for the state's ``dtype``,
    held on the host), or the block built from ``mp, tps, tv`` when it is
    None. Never copies from a device: a ``params`` anywhere but on the CPU,
    or of another dtype, raises ``ValueError``."""
    if params is None:
        return kernel_params(mp, tps, tv, dtype)
    return _build.host_block(params, len(PARAM_NAMES), dtype)


def _kernel_nsub(mode: str, nsub: int) -> int:
    """The substeps a launch takes: ``nsub`` in linearized_average, 1 in
    instantaneous, whose build ignores them as the eager step does."""
    return int(nsub) if mode == "linearized_average" else 1


def _substeps(dt, nsub: int):
    """The launch's substep arguments of linearized_average: ``nsub``,
    ``dt / nsub``, its reciprocal and ``1 / dt``, each a Python float as the
    eager step holds it (models/tendencies.py:bulk_tendencies_1m)."""
    dt_sub = float(dt) / int(nsub)
    return int(nsub), dt_sub, 1.0 / dt_sub, 1.0 / float(dt)


def _prepare(mp, tps, tv, mode: str, nsub: int, nlev: int,
             dtype: torch.dtype, params) -> ctypes.CDLL:
    """The checks and the library of a launch of either entry point on
    CUDA fields of ``dtype`` with ``nlev`` levels."""
    _check_supported(mp, mode, nlev, dtype, nsub)
    return _library(host_params(params, mp, tps, tv, dtype),
                    variant=variant(mp, mode))


def _args(dt, dz, block_cols: int, sediment_cloud: bool, q_tot_affine,
          nsub: int, device: torch.device) -> tuple:
    """The launch arguments both entry points take after ``ncol, nlev``:
    the columns a block steps, the step, the options, the substeps, the
    device and its current stream."""
    return (block_cols, float(dt), float(dz), int(bool(sediment_cloud)),
            *_build.affine(q_tot_affine), *_substeps(dt, nsub), device.index,
            torch.cuda.current_stream(device).cuda_stream)


def step_column_1m_fused(state: ColumnState, mp, tps, tv, dt, dz,
                         mode: str = "instantaneous", nsub: int = 1,
                         sediment_cloud: bool = True,
                         block_cols: int = BLOCK_COLS,
                         q_tot_affine=None, params=None) -> ColumnState:
    """One fused 1M column step on seven ``(ncol, nlev)`` fields.

    ``ncol`` must be a multiple of ``block_cols`` (the columns one thread
    block steps). ``q_tot_affine``: optional ``(scale, bias)`` applied to
    ``q_tot`` on load (``q_tot*scale + bias``). ``params``: the host block
    of :func:`kernel_params` for the state's dtype (the kernel is built for
    its values), built here when not given. CPU tensors take
    :func:`step_column_1m_plain`.
    """
    device = _build.check_fields(state, block_cols, "step_column_1m_fused")
    if device is None:
        return step_column_1m_plain(state, mp, tps, tv, dt, dz, mode=mode,
                                    nsub=nsub, sediment_cloud=sediment_cloud,
                                    q_tot_affine=q_tot_affine)
    ncol, nlev = state.rho.shape
    with trace.span("column.prepare"):
        lib = _prepare(mp, tps, tv, mode, nsub, nlev, state.rho.dtype,
                       params)
        out = ColumnState(*(torch.empty_like(t) for t in state))
        args = _args(dt, dz, block_cols, sediment_cloud, q_tot_affine,
                     _kernel_nsub(mode, nsub), device)
    with _build.launching(lib):
        _build.launch(lib.column1m_step_unpacked,
                      *(t.data_ptr() for t in state),
                      *(t.data_ptr() for t in out), ncol, nlev, *args,
                      span="launch.k1", counter="step_column_1m_fused")
    return out


def step_column_1m_fused_packed(packed: torch.Tensor, mp, tps, tv, dt, dz,
                                mode: str = "instantaneous", nsub: int = 1,
                                sediment_cloud: bool = True,
                                block_cols: int = BLOCK_COLS,
                                q_tot_affine=None,
                                params=None) -> torch.Tensor:
    """Packed-state variant of :func:`step_column_1m_fused`: the state is
    one ``(7, ncol, nlev)`` tensor (see :func:`pack_state`) and maps to a
    like-shaped output. CPU tensors take
    :func:`step_column_1m_packed_plain`."""
    if _build.check_packed(packed, len(_FIELDS), block_cols,
                           "step_column_1m_fused_packed") is None:
        return step_column_1m_packed_plain(
            packed, mp, tps, tv, dt, dz, mode=mode, nsub=nsub,
            sediment_cloud=sediment_cloud, q_tot_affine=q_tot_affine)
    with trace.span("column.prepare"):
        lib = _prepare(mp, tps, tv, mode, nsub, packed.shape[2],
                       packed.dtype, params)
        out = torch.empty_like(packed)
    with _build.launching(lib):
        launch_packed(lib, packed, dt, dz, block_cols, sediment_cloud,
                      q_tot_affine, _kernel_nsub(mode, nsub), out=out)
    trace.count("launches.step_column_1m_fused_packed")
    return out


def launch_packed(lib, packed, dt, dz, block_cols: int,
                  sediment_cloud: bool = True, q_tot_affine=None,
                  nsub: int = 1, out=None):
    """Launch ``lib``'s packed entry point (K1, built for its parameter
    block, dtype and variant) on a checked CUDA ``packed`` state and return
    the output (``out``, or a new tensor when None), in the span
    ``launch.k1``; uncounted (the wrapper counts its own launches).
    ``nsub``: the substeps of a linearized_average build."""
    _, ncol, nlev = packed.shape
    if out is None:
        out = torch.empty_like(packed)
    _build.launch(lib.column1m_step_packed, packed.data_ptr(),
                  out.data_ptr(), ncol * nlev, ncol, nlev,
                  *_args(dt, dz, block_cols, sediment_cloud, q_tot_affine,
                         nsub, packed.device),
                  span="launch.k1")
    return out
