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
or raises ``NotImplementedError`` for what the kernel does not cover: P3
ice (``mp.ice`` set), rain velocity types other than ``SB2006VelType`` and
``Chen2022VelTypeRain``, dtypes other than float32, and more than
:data:`MAX_NLEV` levels.

The kernel's parameters are compiled into it: :func:`kernel_params_2m`
builds the float32 parameter block on the host in float64, and the build
writes each value as an exact float literal into the generated header
(:func:`header`), with the variant (``is_limited``, Chen 2022 fall speeds)
as two more macros. So the library is built once per parameter block and
variant (at its first launch, cached on disk by the header's hash), holds
that one variant, and every constant is an immediate operand. The wrappers
read the block on the host, never from the device. :data:`PARAM_NAMES` is
the only definition of the block's order; the 2M + P3 kernel's list starts
with it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.column import ColumnState2M, _chen_or_sb, step_column_2m
from ..parameters.terminal_velocity import Chen2022VelTypeRain, SB2006VelType
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import eps_numerics, machine_eps
from . import _build
from .column1m import _affine, _check_cuda, _check_tiling

__all__ = [
    "PARAM_NAMES",
    "kernel_params_2m",
    "pack_state_2m",
    "step_column_2m_fused",
    "step_column_2m_fused_packed",
    "step_column_2m_packed_plain",
    "step_column_2m_plain",
    "unpack_state_2m",
]

_FIELDS = ColumnState2M._fields  # (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai)

# The levels the kernel is held to: the most its card tests cover (a warp
# steps a column, so the layout has no bound of its own).
MAX_NLEV = 512
# Columns a thread block steps by default (16 warps, a column each; the
# grid's last, part-empty wave of blocks costs less than with 128): the
# occupancy sweep's pick (PERF.md).
BLOCK_COLS = 16

PARAM_NAMES = (
    # float32 thresholds
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


def _param_values(mp, tps: ThermodynamicsParameters) -> dict:
    """Every float the kernel reads, keyed by :data:`PARAM_NAMES`; the
    products the eager code folds from Python floats are folded here the
    same way, in float64. ``INV_<x>`` is ``1/x`` in float64: PyTorch's CUDA
    division of a tensor by a Python float multiplies by that reciprocal,
    rounded once to float32."""
    f32 = torch.float32
    wr = mp.warm_rain
    sb, aps = wr.seifert_beheng, wr.air_properties
    pdf_r, pdf_c = sb.pdf_r, sb.pdf_c
    acnv, accr, evap = sb.acnv, sb.accr, sb.evap
    vel = _chen_or_sb(mp)
    sbv = vel if isinstance(vel, SB2006VelType) else SB2006VelType()
    chen = vel if isinstance(vel, Chen2022VelTypeRain) else Chen2022VelTypeRain()
    eps = eps_numerics(f32)
    nu = pdf_c.nu_c
    pi = math.pi
    dcp_vl = tps.cp_v - tps.cp_l

    v = dict(
        EM=machine_eps(f32), EN=machine_eps(f32), EPS_MACH=machine_eps(f32),
        TINY=float(torch.finfo(f32).tiny), EPS_PSAT=eps,
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


def kernel_params_2m(mp, tps: ThermodynamicsParameters) -> torch.Tensor:
    """The kernel's float32 parameter block, in :data:`PARAM_NAMES` order,
    on the host (a CPU tensor): the kernel is built for its values."""
    values = _param_values(mp, tps)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    return torch.tensor([values[n] for n in PARAM_NAMES],
                        dtype=torch.float64).to(torch.float32)


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
_F = ctypes.c_float


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
    """The generated header of a parameter block and a variant
    ``(is_limited, chen)`` (:func:`_variant`): ``#define PC_<name>`` as a
    hexadecimal float literal of each value (exact), in :data:`PARAM_NAMES`
    order, ``K3_LIMITED``, ``K3_CHEN`` and ``N_PARAMS``."""
    limited, chen = variant
    if {limited, chen} - {0, 1}:
        raise ValueError(f"a variant is two flags 0 or 1, not {variant}")
    return _build.literal_header("column2m", PARAM_NAMES, params,
                                 (("K3_LIMITED", int(limited)),
                                  ("K3_CHEN", int(chen))))


def library_path(params: torch.Tensor, variant, build: str = "kernel"):
    """The file of one of the kernel library's :data:`BUILDS` for the
    parameter block ``params`` and ``variant`` (built if needed)."""
    return _build.build(SOURCE, "column2m_params.h", header(params, variant),
                        BUILDS[build])


_LIBRARIES = {}


def _library(params: torch.Tensor, variant,
             build: str = "kernel") -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS` for the parameter block
    ``params`` and ``variant``, loaded (built at its first launch, then
    looked up by the block's bytes and the variant)."""
    key = (params.numpy().tobytes(), tuple(variant), build)
    lib = _LIBRARIES.get(key)
    if lib is None:
        lib = _LIBRARIES[key] = bind(
            _build.load(SOURCE, "column2m_params.h", header(params, variant),
                        BUILDS[build]), variant, build == "probe")
    return lib


def bind(lib: ctypes.CDLL, variant, probe: bool = False) -> ctypes.CDLL:
    """Set the C signatures of a loaded build of the source for ``variant``
    (``probe``: the ``-DK3_PROBE`` one) and check it against this module;
    returns it."""
    if not getattr(lib, "_signatures_set", False):
        tail = [_I, _I, _I, _F, _F, _I, _F, _F, _I, _P]
        lib.column2m_step_unpacked.argtypes = [_P] * 14 + tail
        lib.column2m_step_unpacked.restype = _I
        lib.column2m_step_packed.argtypes = [_P, _P, ctypes.c_longlong] + tail
        lib.column2m_step_packed.restype = _I
        lib.column2m_num_params.restype = _I
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
        lib._signatures_set = True
    limited, chen = variant
    if lib.column2m_variant() != 2 * limited + chen:
        raise RuntimeError(f"column2m library built for another variant "
                           f"than {tuple(variant)}")
    return lib


def _check_supported(mp, nlev: int, dtype: torch.dtype) -> None:
    if getattr(mp, "ice", None) is not None:
        raise NotImplementedError(
            "the CUDA 2M column kernel supports warm rain only, not P3 ice")
    vel = _chen_or_sb(mp)
    if type(vel) not in (SB2006VelType, Chen2022VelTypeRain):
        raise NotImplementedError(
            f"the CUDA 2M column kernel supports the SB2006VelType and "
            f"Chen2022VelTypeRain rain velocities, not {type(vel).__name__}")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA 2M column kernel supports float32, not {dtype}")
    if nlev > MAX_NLEV:
        raise NotImplementedError(
            f"the CUDA 2M column kernel supports nlev <= {MAX_NLEV}, "
            f"got {nlev}")


def host_params(params, mp, tps) -> torch.Tensor:
    """The parameter block a launch's library is built for: ``params``
    itself (the block of :func:`kernel_params_2m`, held on the host), or
    the block built from ``mp, tps`` when it is None. Never copies from a
    device: a ``params`` anywhere but on the CPU raises ``ValueError``."""
    if params is None:
        return kernel_params_2m(mp, tps)
    return _build.host_block(params, len(PARAM_NAMES))


def _variant(mp):
    """The kernel's compiled variant: (is_limited, Chen 2022 fall speeds)."""
    return (int(mp.warm_rain.seifert_beheng.pdf_r.is_limited),
            int(isinstance(_chen_or_sb(mp), Chen2022VelTypeRain)))


def step_column_2m_fused(state: ColumnState2M, mp, tps, dt, dz,
                         block_cols: int = BLOCK_COLS,
                         params=None) -> ColumnState2M:
    """One fused 2M warm-rain column step on seven ``(ncol, nlev)`` fields.

    ``ncol`` must be a multiple of ``block_cols`` (the columns one thread
    block steps). ``params``: the host block of :func:`kernel_params_2m`
    (the kernel is built for its values), built here when not given. CPU
    tensors take :func:`step_column_2m_plain`.
    """
    ncol, nlev = state.rho.shape
    _check_tiling(ncol, block_cols)
    for t in state:
        if t.shape != (ncol, nlev):
            raise ValueError(f"every field must be {(ncol, nlev)}, "
                             f"got {tuple(t.shape)}")
    if state.rho.device.type == "cpu":
        return step_column_2m_plain(state, mp, tps, dt, dz)
    device = _check_cuda(list(state), "step_column_2m_fused")
    _check_supported(mp, nlev, state.rho.dtype)
    lib = _library(host_params(params, mp, tps), _variant(mp))
    out = ColumnState2M(*(torch.empty_like(t) for t in state))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.column2m_step_unpacked(
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in out),
        ncol, nlev, block_cols, float(dt), float(dz), 0, 0.0, 0.0,
        device.index, stream)
    if err:
        raise RuntimeError(f"column2m_step_unpacked launch failed: CUDA "
                           f"error {err}")
    step_column_2m_fused.launches += 1
    return out


step_column_2m_fused.launches = 0


def step_column_2m_fused_packed(packed: torch.Tensor, mp, tps, dt, dz,
                                block_cols: int = BLOCK_COLS,
                                q_tot_affine=None,
                                params=None) -> torch.Tensor:
    """Packed-state variant of :func:`step_column_2m_fused`: the state is
    one ``(7, ncol, nlev)`` tensor (see :func:`pack_state_2m`) and maps to a
    like-shaped output. ``q_tot_affine``: optional ``(scale, bias)`` applied
    to ``q_tot`` on load (``q_tot*scale + bias``). CPU tensors take
    :func:`step_column_2m_packed_plain`."""
    if packed.dim() != 3 or packed.shape[0] != len(_FIELDS):
        raise ValueError(f"packed state must be (7, ncol, nlev), got "
                         f"{tuple(packed.shape)}")
    _, ncol, nlev = packed.shape
    _check_tiling(ncol, block_cols)
    if packed.device.type == "cpu":
        return step_column_2m_packed_plain(packed, mp, tps, dt, dz,
                                           q_tot_affine=q_tot_affine)
    _check_cuda([packed], "step_column_2m_fused_packed")
    _check_supported(mp, nlev, packed.dtype)
    out = launch_packed(_library(host_params(params, mp, tps), _variant(mp)),
                        packed, dt, dz, block_cols, q_tot_affine)
    step_column_2m_fused_packed.launches += 1
    return out


step_column_2m_fused_packed.launches = 0


def launch_packed(lib, packed, dt, dz, block_cols: int, q_tot_affine=None):
    """Launch ``lib``'s packed entry point (K3, built for its parameter
    block and variant) on a checked CUDA ``packed`` state and return the
    output; uncounted (the wrapper counts its own launches)."""
    _, ncol, nlev = packed.shape
    device = packed.device
    out = torch.empty_like(packed)
    has_affine, scale, bias = _affine(q_tot_affine)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.column2m_step_packed(
        packed.data_ptr(), out.data_ptr(), ncol * nlev, ncol, nlev,
        block_cols, float(dt), float(dz), has_affine, scale, bias,
        device.index, stream)
    if err:
        raise RuntimeError(f"column2m_step_packed launch failed: CUDA "
                           f"error {err}")
    return out
