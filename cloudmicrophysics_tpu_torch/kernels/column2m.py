"""Fused 2M warm-rain column step as one hand-written CUDA kernel, beside
its plain PyTorch version.

Port of ``cloudmicrophysics_tpu/kernels/column2m.py``. The CUDA source
``csrc/column2m.cu`` (with the warm-rain device code of ``csrc/warm2m.cuh``,
which the 2M + P3 kernel shares) computes, per ``(column, level)`` cell and in one pass
over the seven prognostic fields (rho, T, q_tot, q_lcl, n_lcl, q_rai,
n_rai), everything :func:`..models.column.step_column_2m` computes: the
constant-tau condensation/evaporation, rain evaporation, autoconversion and
cloud self-collection, accretion, rain self-collection and breakup, the
Horn-2012 number adjustment, the number- and mass-weighted rain fall speeds
(SB2006 or Chen 2022), the upwind sedimentation fluxes, the latent-heat
temperature update and the final clamp. Two entry points share it:

* :func:`step_column_2m_fused` — seven ``(ncol, nlev)`` fields in, seven
  out (the Pallas ``step_column_2m_pallas``);
* :func:`step_column_2m_fused_packed` — one ``(7, ncol, nlev)`` buffer in
  and out, with the optional in-kernel ``q_tot`` affine (the Pallas
  ``step_column_2m_pallas_packed``).

A CPU tensor takes the plain version (:func:`step_column_2m_plain`,
:func:`step_column_2m_packed_plain`). A CUDA tensor launches the kernel,
float32 or float64, at any number of levels (warps are independent, so the
layout has no bound of its own), or raises ``NotImplementedError`` for what
the kernel does not cover: P3 ice (``mp.ice`` set), rain velocity types
other than ``SB2006VelType`` and ``Chen2022VelTypeRain``, and other dtypes.

The kernel's parameters are compiled into it: :func:`kernel_params_2m`
builds the parameter block of a dtype (its values computed on the host in
float64, with the dtype's own thresholds) and the build writes each value
as an exact literal of that dtype into the generated header
(:func:`header`), with the scalar type and the variant (``is_limited``,
Chen 2022 fall speeds) as three more macros. So the library is built once
per parameter block, dtype and variant (at its first launch, cached on
disk by the header's hash), holds that one variant, and every constant is
an immediate operand. The wrappers
read the block on the host, never from the device. :data:`PARAM_NAMES` is
the only definition of the block's order; the 2M + P3 kernel's list starts
with it.

Launch plan: a thread block's ``block_cols`` columns are split into as
many contiguous ranges of whole columns as the build has warps (16 at
float32, 8 at float64), their sizes differing by at most one; a warp steps
its range, one run of consecutive cells in the ``(ncol, nlev)`` layout, in
windows of 32 cells, a lane a cell, so a window may straddle columns and no
lane idles at a column's top (:func:`lane_slots`). Each K3 or K4 launch adds
the lane slots its plan steps to the counter ``k3.lane_slots`` and its
cells to ``k3.cells``; their ratio is the share of busy lanes. The probe
build (float32 only) counts the windows its warps step, which the card's
tests hold to the slots over 32.

Each launch adds one to the counter ``launches.<wrapper>``
(:mod:`..trace`); under the profiler a wrapper's checks, parameter block,
library and output are the span ``column.prepare``, and its launch the span
``launch.k3`` (packed) or ``launch.k4`` (fields).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import trace
from ..models.column import ColumnState2M, _chen_or_sb, step_column_2m
from ..parameters.terminal_velocity import Chen2022VelTypeRain, SB2006VelType
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import eps_numerics, machine_eps
from . import _build

__all__ = [
    "PARAM_NAMES",
    "kernel_params_2m",
    "lane_slots",
    "pack_state_2m",
    "step_column_2m_fused",
    "step_column_2m_fused_packed",
    "step_column_2m_packed_plain",
    "step_column_2m_plain",
    "unpack_state_2m",
    "warm_variant",
]

_FIELDS = ColumnState2M._fields  # (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai)

# Columns a thread block steps by default (16 warps, a column each; the
# grid's last, part-empty wave of blocks costs less than with 128): the
# occupancy sweep's pick (PERF.md).
BLOCK_COLS = 16

PARAM_NAMES = (
    # thresholds of the dtype
    "EM", "EN", "EPS_MACH", "TINY", "EPS_PSAT",
    # thermodynamics
    "T_0", "LH_V0", "DCP_VL", "CP_D", "CPVD", "CPLV", "CPIV", "R_V", "INV_R_V",
    "PRESS_TRIPLE", "INV_T_TRIPLE", "KV_L", "CL_L",
    # air: G function and ventilation
    "INV_K_THERM", "INV_D_VAPOR", "INV_NU_AIR", "CBRT_SC",
    # condensation/evaporation relaxation
    "TAU_CE",
    # rain and cloud PSDs
    "XR_MIN", "XR_MAX", "N0_MIN", "N0_MAX", "LAM_MIN", "LAM_MAX",
    "PI_RHO_W", "INV_PI_RHO_W", "PDF_RHO0", "INV_XR_MIN", "INV_XR_MAX",
    "INV_XC_MIN", "INV_XC_MAX",
    # autoconversion and cloud self-collection
    "ACNV_C", "X_STAR", "INV_X_STAR", "ACNV_RHO0", "ACNV_A", "ACNV_AEXP",
    "ACNV_BEXP", "SC_LCL_C",
    # accretion
    "KCR", "TAU0", "ACCR_C", "ACCR_RHO0",
    # rain self-collection and breakup
    "KRR_NEG", "KAPPA_RR", "SC_D", "DEQ", "DR_TH", "KBR", "KAPPA_BR",
    # rain evaporation
    "SIX_X_STAR", "A_VENT_0", "B_VENT_0",
    "GIA_C0_A", "GIA_E0_A", "GIA_C1_A", "GIA_E1_A",
    "GIA_C0_B", "GIA_E0_B", "GIA_C1_B", "GIA_E1_B",
    "ALPHA", "BETA", "EVAP_RHO0", "A_VENT_1", "B_VENT_1_SC", "TWO_PI",
    # Horn 2012 number adjustment
    "INV_NUMADJ_TAU",
    # rain fall speeds: SB2006 (Rogers-type) and Chen 2022
    "VEL_RHO0", "AR", "BR", "CR", "TWO_RC",
    "CH_RHO0", "CH_BRHO", "LOG1000", "CH_A1U", "CH_A2U", "CH_A3U",
    "CH_A3POW", "CH_B1", "CH_B2", "CH_B3", "CH_C1U", "CH_C2U", "CH_C3U",
)


def _gamma_incl_consts(a: float):
    """The four Python-float factors of ``ops.m2.gamma_incl_approx(a, x)``."""
    return 0.33 - 0.7 * a, 0.08 - 0.93 * a, 1.34 - 0.1 * a, 0.8 - a


def _param_values(mp, tps: ThermodynamicsParameters,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Every value the kernel reads, keyed by :data:`PARAM_NAMES`, with the
    thresholds of ``dtype``; the products the eager code folds from Python
    floats are folded here the same way, in float64. ``INV_<x>`` is ``1/x``
    in float64: PyTorch's CUDA division of a tensor by a Python float
    multiplies by that reciprocal, rounded once to the tensor's dtype."""
    wr = mp.warm_rain
    sb, aps = wr.seifert_beheng, wr.air_properties
    pdf_r, pdf_c = sb.pdf_r, sb.pdf_c
    acnv, accr, evap = sb.acnv, sb.accr, sb.evap
    vel = _chen_or_sb(mp)
    sbv = vel if isinstance(vel, SB2006VelType) else SB2006VelType()
    chen = vel if isinstance(vel, Chen2022VelTypeRain) else Chen2022VelTypeRain()
    eps = eps_numerics(dtype)
    nu = pdf_c.nu_c
    pi = math.pi
    dcp_vl = tps.cp_v - tps.cp_l

    v = dict(
        EM=machine_eps(dtype), EN=machine_eps(dtype), EPS_MACH=machine_eps(dtype),
        TINY=float(torch.finfo(dtype).tiny), EPS_PSAT=eps,
        T_0=tps.T_0, LH_V0=tps.LH_v0, DCP_VL=dcp_vl, CP_D=tps.cp_d,
        CPVD=tps.cp_v - tps.cp_d, CPLV=tps.cp_l - tps.cp_v,
        CPIV=tps.cp_i - tps.cp_v, R_V=tps.R_v,
        INV_R_V=1 / tps.R_v, PRESS_TRIPLE=tps.press_triple,
        INV_T_TRIPLE=1 / tps.T_triple, KV_L=dcp_vl / tps.R_v,
        CL_L=(tps.LH_v0 - dcp_vl * tps.T_0) / tps.R_v,
        INV_K_THERM=1 / max(aps.K_therm, eps),
        INV_D_VAPOR=1 / max(aps.D_vapor, eps), INV_NU_AIR=1 / aps.nu_air,
        CBRT_SC=(aps.nu_air / max(aps.D_vapor, eps)) ** (1 / 3),
        TAU_CE=wr.condevap.tau_relax,
        INV_PI_RHO_W=1 / (pi * pdf_r.rho_w), PDF_RHO0=pdf_r.rho0,
        INV_XR_MIN=1 / pdf_r.xr_min, INV_XR_MAX=1 / pdf_r.xr_max,
        INV_XC_MIN=1 / pdf_c.xc_min, INV_XC_MAX=1 / pdf_c.xc_max,
        ACNV_C=(acnv.kcc / 20 / acnv.x_star * (nu + 2) * (nu + 4)
                / (nu + 1) ** 2),
        X_STAR=acnv.x_star, INV_X_STAR=1 / acnv.x_star,
        ACNV_RHO0=acnv.rho0, ACNV_A=acnv.A,
        ACNV_AEXP=acnv.a, ACNV_BEXP=acnv.b,
        SC_LCL_C=-acnv.kcc * (nu + 2) / (nu + 1),
        KCR=accr.kcr, TAU0=accr.tau0, ACCR_C=accr.c, ACCR_RHO0=accr.rho0,
        KRR_NEG=-sb.self_col.krr, KAPPA_RR=sb.self_col.kappa_rr,
        SC_D=sb.self_col.d,
        DEQ=sb.brek.Deq, DR_TH=sb.brek.Dr_th, KBR=sb.brek.kbr,
        KAPPA_BR=sb.brek.kappa_br,
        SIX_X_STAR=6 * pdf_r.xr_min, A_VENT_0=evap.a_vent_0_coeff,
        B_VENT_0=evap.b_vent_0_coeff, ALPHA=evap.alpha, BETA=evap.beta,
        EVAP_RHO0=evap.rho0, A_VENT_1=evap.a_vent_1,
        B_VENT_1_SC=evap.b_vent_1
        * (aps.nu_air / max(aps.D_vapor, eps)) ** (1 / 3),
        TWO_PI=2 * pi,
        INV_NUMADJ_TAU=1 / sb.numadj.tau,
        VEL_RHO0=sbv.rho0, AR=sbv.aR, BR=sbv.bR, CR=sbv.cR,
        TWO_RC=2 * (-1 / (2 * sbv.cR) * math.log(sbv.aR / sbv.bR)),
        **rain_pdf_values(pdf_r), **chen_rain_values(chen),
    )
    for tag, a in (("A", -1.0), ("B", evap.beta_vent_0)):
        for name, c in zip(("C0", "E0", "C1", "E1"), _gamma_incl_consts(a)):
            v[f"GIA_{name}_{tag}"] = c
    return v


def rain_pdf_values(pdf_r) -> dict:
    """The rain PSD block of the parameter list (``XR_MIN`` ...
    ``PI_RHO_W``, the order ``pdf_rain`` in ``csrc/warm2m.cuh`` reads)."""
    return dict(XR_MIN=pdf_r.xr_min, XR_MAX=pdf_r.xr_max,
                N0_MIN=pdf_r.N0_min, N0_MAX=pdf_r.N0_max,
                LAM_MIN=pdf_r.lambda_min, LAM_MAX=pdf_r.lambda_max,
                PI_RHO_W=math.pi * pdf_r.rho_w)


def chen_rain_values(chen: Chen2022VelTypeRain) -> dict:
    """The Chen 2022 rain block of the parameter list (``CH_RHO0`` ...
    ``CH_C3U``, the order ``chen_rain_coeffs`` in ``csrc/warm2m.cuh``
    reads)."""
    v = dict(CH_RHO0=chen.rho0, CH_BRHO=chen.b_rho, LOG1000=math.log(1000.0))
    for i in range(3):
        v[f"CH_A{i + 1}U"] = chen.a[i] * 1000.0 ** chen.b[i]
    v["CH_A3POW"] = chen.a3_pow
    for i in range(3):
        v[f"CH_B{i + 1}"] = chen.b[i]
    for i in range(3):
        v[f"CH_C{i + 1}U"] = chen.c[i] * 1000.0
    return v


def kernel_params_2m(mp, tps: ThermodynamicsParameters,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's parameter block for ``dtype`` (float32 or float64), in
    :data:`PARAM_NAMES` order, on the host (a CPU tensor of that dtype): the
    kernel is built for its values."""
    _build.check_dtype(dtype, "2M")
    values = _param_values(mp, tps, dtype)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    return torch.tensor([values[n] for n in PARAM_NAMES],
                        dtype=torch.float64).to(dtype)


# ---------------------------------------------------------------------------
# Packed state
# ---------------------------------------------------------------------------

def pack_state_2m(state: ColumnState2M) -> torch.Tensor:
    """Stack the 7 prognostic 2M fields into one ``(7, ncol, nlev)`` buffer
    (structure of arrays): one read and one write stream per step."""
    return torch.stack(list(state), dim=0)


def unpack_state_2m(packed: torch.Tensor) -> ColumnState2M:
    """Inverse of :func:`pack_state_2m` (views into ``packed``)."""
    return ColumnState2M(*packed.unbind(0))


# ---------------------------------------------------------------------------
# Plain versions (eager PyTorch): the CPU path and the kernels' reference
# ---------------------------------------------------------------------------

def step_column_2m_plain(state: ColumnState2M, mp, tps, dt, dz,
                         q_tot_affine=None) -> ColumnState2M:
    """What :func:`step_column_2m_fused` computes, in eager PyTorch."""
    if q_tot_affine is not None:
        scale, bias = q_tot_affine
        state = state._replace(q_tot=state.q_tot * scale + bias)
    return step_column_2m(state, mp, tps, dt, dz)


def step_column_2m_packed_plain(packed: torch.Tensor, mp, tps, dt, dz,
                                q_tot_affine=None) -> torch.Tensor:
    """What :func:`step_column_2m_fused_packed` computes, in eager PyTorch:
    unpack, step, pack."""
    return pack_state_2m(step_column_2m_plain(
        unpack_state_2m(packed), mp, tps, dt, dz, q_tot_affine=q_tot_affine))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


SOURCE = "column2m.cu"
# nvcc flags of each build of the source: the one the wrappers launch
# (-lineinfo leaves the code as it is and maps each SASS instruction to its
# source line, which kernels/opcount.py reads) and the stage-timing probe
BUILDS = {
    "kernel": ("-lineinfo",),
    "probe": ("-lineinfo", "-DK3_PROBE"),
}
# the stages the probe build times, in the order of enum ProbeStage
PROBE_STAGES = ("load", "cell", "exchange", "store")


def header(params: torch.Tensor, variant) -> str:
    """The generated header of a parameter block (float32 or float64) and a
    variant ``(is_limited, chen)`` (:func:`_variant`): ``#define PC_<name>``
    as a hexadecimal literal of each value in the block's dtype (exact), in
    :data:`PARAM_NAMES` order, ``K3_REAL`` (the scalar type), ``K3_LIMITED``,
    ``K3_CHEN`` and ``N_PARAMS``."""
    limited, chen = variant
    if {limited, chen} - {0, 1}:
        raise ValueError(f"a variant is two flags 0 or 1, not {variant}")
    return _build.literal_header("column2m", PARAM_NAMES, params,
                                 (("K3_REAL", _build.c_type(params.dtype)),
                                  ("K3_LIMITED", int(limited)),
                                  ("K3_CHEN", int(chen))))


def library_path(params: torch.Tensor, variant, build: str = "kernel"):
    """The file of one of the kernel library's :data:`BUILDS` for the
    parameter block ``params`` and ``variant`` (built if needed)."""
    return _build.build(SOURCE, "column2m_params.h", header(params, variant),
                        BUILDS[build] + _build.dtype_flags(params.dtype))


def _library(params: torch.Tensor, variant,
             build: str = "kernel") -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS` for the parameter block
    ``params`` and ``variant``, loaded and bound (:func:`_build.library`)."""
    return _build.library(
        SOURCE, build, variant, lambda: library_path(params, variant, build),
        lambda lib: bind(lib, variant, build == "probe", params.dtype),
        block=params)


def bind(lib: ctypes.CDLL, variant, probe: bool = False,
         dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """Set the C signatures of a loaded build of the source for ``variant``
    and ``dtype`` (``probe``: the ``-DK3_PROBE`` one) and check it against
    this module; returns it."""
    _F = _build.c_scalar(dtype)
    tail = [_I, _I, _I, _F, _F, _I, _F, _F, _I, _P]
    lib.column2m_step_unpacked.argtypes = [_P] * 14 + tail
    lib.column2m_step_unpacked.restype = _I
    lib.column2m_step_packed.argtypes = [_P, _P, ctypes.c_longlong] + tail
    lib.column2m_step_packed.restype = _I
    lib.column2m_num_params.restype = _I
    lib.column2m_real_bytes.restype = _I
    lib.column2m_threads_per_block.restype = _I
    lib.column2m_variant.restype = _I
    lib.column2m_blocks_per_sm.argtypes = [_I, _P]
    lib.column2m_blocks_per_sm.restype = _I
    lib.column2m_kernel_attrs.argtypes = [_P, _P]
    lib.column2m_kernel_attrs.restype = _I
    if probe:
        lib.column2m_probe_set.argtypes = [_P, _I]
        lib.column2m_probe_set.restype = _I
        lib.column2m_probe_stages.restype = _I
        if lib.column2m_probe_stages() != len(PROBE_STAGES):
            raise RuntimeError("column2m probe built with another "
                               "stage list")
    if lib.column2m_num_params() != len(PARAM_NAMES):
        raise RuntimeError("column2m library built from another "
                           "parameter list")
    if lib.column2m_real_bytes() != dtype.itemsize:
        raise RuntimeError(f"column2m library built for another dtype "
                           f"than {dtype}")
    limited, chen = variant
    if lib.column2m_variant() != 2 * limited + chen:
        raise RuntimeError(f"column2m library built for another variant "
                           f"than {tuple(variant)}")
    return lib


def check_warm_rain(mp, nlev: int, dtype: torch.dtype) -> None:
    """Raise for what the kernel's warm rain (``mp.warm_rain``, all this
    reads of ``mp``) cannot step: another rain velocity type than SB2006 and
    Chen 2022, another dtype than float32 and float64
    (``NotImplementedError``), no levels (``ValueError``)."""
    vel = _chen_or_sb(mp)
    if type(vel) not in (SB2006VelType, Chen2022VelTypeRain):
        raise NotImplementedError(
            f"the CUDA 2M column kernel supports the SB2006VelType and "
            f"Chen2022VelTypeRain rain velocities, not {type(vel).__name__}")
    _build.check_dtype(dtype, "2M")
    if nlev < 1:
        raise ValueError(f"the CUDA 2M column kernel needs nlev >= 1, got "
                         f"{nlev}")


def _check_supported(mp, nlev: int, dtype: torch.dtype) -> None:
    """Raise for what the kernel cannot step: P3 ice, then
    :func:`check_warm_rain`."""
    if getattr(mp, "ice", None) is not None:
        raise NotImplementedError(
            "the CUDA 2M column kernel supports warm rain only, not P3 ice")
    check_warm_rain(mp, nlev, dtype)


def host_params(params, mp, tps,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The parameter block a launch's library is built for: ``params``
    itself (the block of :func:`kernel_params_2m` for the state's ``dtype``,
    held on the host), or the block built from ``mp, tps`` when it is None.
    Never copies from a device: a ``params`` anywhere but on the CPU, or of
    another dtype, raises ``ValueError``."""
    if params is None:
        return kernel_params_2m(mp, tps, dtype)
    return _build.host_block(params, len(PARAM_NAMES), dtype)


def warm_variant(mp) -> tuple:
    """The kernel's compiled variant of the warm rain (``mp.warm_rain``,
    all this reads of ``mp``): ``(is_limited, Chen 2022 fall speeds)``."""
    return (int(mp.warm_rain.seifert_beheng.pdf_r.is_limited),
            int(isinstance(_chen_or_sb(mp), Chen2022VelTypeRain)))


# the name chip_smoke.py and bench_h100/tools/count_work_2m.py call
_variant = warm_variant


def _prepare(mp, tps, nlev: int, dtype: torch.dtype, params) -> ctypes.CDLL:
    """The checks and the library of a launch of either entry point on
    CUDA fields of ``dtype`` with ``nlev`` levels."""
    _check_supported(mp, nlev, dtype)
    return _library(host_params(params, mp, tps, dtype), warm_variant(mp))


def lane_slots(ncol: int, nlev: int, block_cols: int, warps: int) -> int:
    """The lane slots a K3 or K4 launch steps on ``(ncol, nlev)`` at
    ``block_cols`` columns a block with ``warps`` warps a block: the sum
    over warps of their runs' cells rounded up to whole 32-cell windows.
    A block's columns (the grid's last block may have fewer) are split into
    ``warps`` ranges whose sizes differ by at most one."""
    def block(cols: int) -> int:
        share, extra = divmod(cols, warps)
        return sum(n * -(-c * nlev // 32) * 32
                   for n, c in ((extra, share + 1), (warps - extra, share)))

    full, rest = divmod(ncol, block_cols)
    return full * block(block_cols) + (block(rest) if rest else 0)


@functools.lru_cache(maxsize=64)
def _plan(lib, ncol: int, nlev: int, block_cols: int) -> tuple:
    """A launch's lane slots and cells on the build ``lib``, whose warps a
    block are its threads over 32; worked out once a library and shape."""
    warps = lib.column2m_threads_per_block() // 32
    return lane_slots(ncol, nlev, block_cols, warps), ncol * nlev


def _count_plan(lib, ncol: int, nlev: int, block_cols: int) -> None:
    """Add a launch's lane slots and cells to ``k3.lane_slots`` and
    ``k3.cells``."""
    slots, cells = _plan(lib, ncol, nlev, block_cols)
    trace.count("k3.lane_slots", slots)
    trace.count("k3.cells", cells)


def _args(dt, dz, block_cols: int, q_tot_affine,
          device: torch.device) -> tuple:
    """The launch arguments both entry points take after ``ncol, nlev``:
    the columns a block steps, the step, the ``q_tot`` affine, the device
    and its current stream."""
    return (block_cols, float(dt), float(dz), *_build.affine(q_tot_affine),
            device.index, torch.cuda.current_stream(device).cuda_stream)


def step_column_2m_fused(state: ColumnState2M, mp, tps, dt, dz,
                         block_cols: int = BLOCK_COLS,
                         params=None) -> ColumnState2M:
    """One fused 2M warm-rain column step on seven ``(ncol, nlev)`` fields.

    ``ncol`` must be a multiple of ``block_cols`` (the columns one thread
    block steps). ``params``: the host block of :func:`kernel_params_2m`
    (the kernel is built for its values), built here when not given. CPU
    tensors take :func:`step_column_2m_plain`.
    """
    device = _build.check_fields(state, block_cols, "step_column_2m_fused")
    if device is None:
        return step_column_2m_plain(state, mp, tps, dt, dz)
    ncol, nlev = state.rho.shape
    with trace.span("column.prepare"):
        lib = _prepare(mp, tps, nlev, state.rho.dtype, params)
        out = ColumnState2M(*(torch.empty_like(t) for t in state))
        args = _args(dt, dz, block_cols, None, device)
    with _build.launching(lib):
        _build.launch(lib.column2m_step_unpacked,
                      *(t.data_ptr() for t in state),
                      *(t.data_ptr() for t in out), ncol, nlev, *args,
                      span="launch.k4", counter="step_column_2m_fused")
    _count_plan(lib, ncol, nlev, block_cols)
    return out


def step_column_2m_fused_packed(packed: torch.Tensor, mp, tps, dt, dz,
                                block_cols: int = BLOCK_COLS,
                                q_tot_affine=None,
                                params=None) -> torch.Tensor:
    """Packed-state variant of :func:`step_column_2m_fused`: the state is
    one ``(7, ncol, nlev)`` tensor (see :func:`pack_state_2m`) and maps to a
    like-shaped output. ``q_tot_affine``: optional ``(scale, bias)`` applied
    to ``q_tot`` on load (``q_tot*scale + bias``). CPU tensors take
    :func:`step_column_2m_packed_plain`."""
    if _build.check_packed(packed, len(_FIELDS), block_cols,
                           "step_column_2m_fused_packed") is None:
        return step_column_2m_packed_plain(packed, mp, tps, dt, dz,
                                           q_tot_affine=q_tot_affine)
    with trace.span("column.prepare"):
        lib = _prepare(mp, tps, packed.shape[2], packed.dtype, params)
        out = torch.empty_like(packed)
    with _build.launching(lib):
        launch_packed(lib, packed, dt, dz, block_cols, q_tot_affine, out=out)
    trace.count("launches.step_column_2m_fused_packed")
    return out


def launch_packed(lib, packed, dt, dz, block_cols: int, q_tot_affine=None,
                  out=None):
    """Launch ``lib``'s packed entry point (K3, built for its parameter
    block and variant) on a checked CUDA ``packed`` state and return the
    output (``out``, or a new tensor when None), in the span ``launch.k3``,
    adding its plan to ``k3.lane_slots`` and ``k3.cells``; uncounted in
    ``launches.*`` (the wrapper counts its own launches)."""
    _, ncol, nlev = packed.shape
    if out is None:
        out = torch.empty_like(packed)
    _build.launch(lib.column2m_step_packed, packed.data_ptr(),
                  out.data_ptr(), ncol * nlev, ncol, nlev,
                  *_args(dt, dz, block_cols, q_tot_affine, packed.device),
                  span="launch.k3")
    _count_plan(lib, ncol, nlev, block_cols)
    return out
