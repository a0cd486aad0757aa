"""2M warm rain + P3 ice column step as three hand-written CUDA kernels,
beside its plain PyTorch version.

Port of ``cloudmicrophysics_tpu/kernels/column_p3.py``. The CUDA source
``csrc/column_p3.cu`` (with the warm-rain device code of ``csrc/warm2m.cuh``,
shared with the 2M kernel) computes everything
:func:`..models.column.step_column_p3` computes, in three kernels launched
one after the other on the current stream and joined by a scratch record
of :data:`SCRATCH_FIELDS` rows of ``ncol * nlev`` in the state's dtype
(:func:`launch_plan` gives their grids):

* K5a (:func:`launch_solve`), a thread per cell: the P3 shape solve
  (warm-started from an optional ``loglambda_guess``), the sanitized state,
  the PSD and the integration bounds, the cloud window of the collisions
  and the node pass's per-cell factors; :func:`loglambda_p3_fused` runs it
  alone;
* K5b (:func:`launch_nodes`), a warp per cell (4N lanes when they divide a
  warp), walking the cell's 4N ice quadrature nodes in chunks of two nodes
  a lane at float32 and one at float64, the last chunk in only the lane
  passes that hold a node (:func:`node_passes`): every contraction over the
  ice nodes (liquid-ice collisions,
  blocked self-collection, melt, the weighted fall speeds), each node-axis
  sum added one node at a time in node order;
* K5c (:func:`launch_epilogue`), a thread per cell in blocks of whole
  columns, each walked from the top in chunks of at most
  :data:`EPILOGUE_THREADS` levels: the nucleation, freezing,
  sublimation/deposition and
  number-adjustment rates, the SB2006 warm rates, rain and ice
  sedimentation, latent heating, the clamp and ``q_rim <= q_ice``.

:func:`step_column_p3_fused` runs the three and returns ``(new_state,
loglambda)``.

The same source built with ``-DK5_TEND`` (:data:`TEND_BUILDS`) is the
point-wise fused tendencies of ``bulk_tendencies_2m`` with P3 ice
(:func:`p3_tendencies_fused`, what :func:`..models.tendencies.
bulk_tendencies_2m` launches on CUDA fields): K5a with log lambda an input
rather than solved (:func:`launch_tend_bounds`), K5b without the node pass
of warps that hold no ice, and a thread a
point running K5c's rates with a per-point INP log shift, writing the eight
:class:`..models.tendencies.Tendencies2M` fields (:func:`launch_tend_rates`):
no column, no sedimentation, no update.

A CPU tensor takes the plain version (:func:`step_column_p3_plain`, the eager
step). A CUDA tensor launches the kernels, in the whole scope of the eager
step: float32 and float64, any number of levels, any quadrature order
(Gauss-Legendre or Chebyshev-Gauss), either slope law, either aspect ratio,
a limited or unlimited ice rain PSD, and the warm rain's options. It raises
``NotImplementedError`` only for what the JAX step cannot run either:
parameters without P3 ice, ice nucleation other than ``Frostenberg2023``,
another dtype, and a rain velocity type the 2M step does not take. What
changes the code is a build of the source (:func:`variant`: the dtype, the
order, the slope law, the aspect ratio, the ice rain PSD's limiters), built
at its first launch and cached on disk; both ``is_limited`` values and both
rain velocity types of the warm rain are compiled variants of K5c, picked at
launch; any float override is data in the parameter buffer.

The kernels read the parameters from one device buffer of the state's
dtype, built on the host in float64 by :func:`kernel_params_p3`: the
scalars, in the order of :data:`PARAM_NAMES` (which starts with the 2M
kernel's list, so the shared warm-rain code reads the same indices), then
the node/weight tables of the order's rules. The build writes the matching
``#define P_<name>`` header from :data:`PARAM_NAMES`, with the variant's
macros.

On CUDA tensors a step's preparation (the checks, the launch plan, the
parameter buffer, the library, the outputs and the scratch record) is the
span ``column.prepare`` and its three launches the spans ``launch.k5a``,
``launch.k5b`` and ``launch.k5c``; each launch adds one to the counter
``launches.<launcher>`` and each step to ``launches.step_column_p3_fused``;
K5b's launch adds the lane-node evaluations of its launch plan to
``k5b.node_evals`` and the ice nodes it sums to ``k5b.nodes``
(:mod:`..trace`). A tendency call launches ``launch.p3tend_bounds``,
``launch.k5b`` and ``launch.p3tend_rates`` (counters
``launches.launch_tend_bounds``, ``launches.launch_nodes``,
``launches.launch_tend_rates``); its K5b skips a warp none of whose cells
holds ice (the rates kernel discards such a cell's sums by select) and
adds the cells it ran to the device counter :data:`ICE_POINTS`, so there
``k5b.node_evals`` and ``k5b.nodes`` count the launch plan, not the nodes
run.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch._C._functorch import is_functorch_wrapped_tensor

from .. import trace
from ..models import tendencies as BMT
from ..models.column import ColumnStateP3, step_column_p3
from ..ops import common as CO
from ..ops import p3 as P3
from ..ops import thermo as TDI
from ..ops.p3_processes import liquid_quadrature, self_collection_inner_orders
from ..parameters.ice_nucleation import Frostenberg2023
from ..parameters.p3 import OBLATE, SlopeConstant, SlopePowerLaw
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.quadrature import GaussLegendre
from ..utils.special import machine_eps
from . import _build
from . import column2m as K2M
from .activation import broadcast_shape
from .column2m import warm_variant

__all__ = [
    "PARAM_NAMES",
    "SCRATCH_FIELDS",
    "Variant",
    "kernel_params_p3",
    "launch_plan",
    "loglambda_p3_fused",
    "loglambda_p3_plain",
    "node_passes",
    "p3_tendencies_fused",
    "step_column_p3_fused",
    "step_column_p3_plain",
    "variant",
]

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
    # P3 scheme: mass, area, slope (power law; constant), rime, ventilation
    "PI_F", "INV_PI", "ALPHA_VA", "BETA_VA", "RHO_I", "INV_RHO_I", "RHOI_PI6",
    "SIX_ALPHA", "THR_EXP", "D_TH", "RHO_RIM_MAX", "RHOD_NEGP", "RHOD_1MP",
    "THREE_SQRT_PI", "AREA_GAMMA", "AREA_SIGMA", "SLOPE_A", "SLOPE_B",
    "SLOPE_C", "MU_MAX", "SLOPE_MU", "P3_T_FREEZE", "INV_TAU_WET",
    "P3_VENT_A", "P3_VENT_BC", "RRL_A", "RRL_B", "RRL_C", "RRL_RHO8",
    "RRL_RHO_ICE",
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

# the numpy scalar of each dtype a build takes
_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _p_sat_ice_at_freezing(tps: ThermodynamicsParameters) -> float:
    """The saturation vapor pressure over ice at ``tps.T_freeze``, a Python
    float (the eager step folds it on the host, in float64)."""
    T = torch.tensor(tps.T_freeze, dtype=torch.float64)
    return float(TDI.saturation_vapor_pressure_over_ice(tps, T))


def _slope_values(slope) -> dict:
    """The slope law's parameters: the power law's, or the constant mu (the
    other law's entries are 0 and not read by its build)."""
    if isinstance(slope, SlopeConstant):
        return dict(SLOPE_A=0.0, SLOPE_B=0.0, SLOPE_C=0.0, MU_MAX=0.0,
                    SLOPE_MU=slope.mu)
    return dict(SLOPE_A=slope.a, SLOPE_B=slope.b, SLOPE_C=slope.c,
                MU_MAX=slope.mu_max, SLOPE_MU=0.0)


def _param_values_p3(mp, tps: ThermodynamicsParameters,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Every scalar the kernel reads, keyed by :data:`PARAM_NAMES`, with the
    thresholds of ``dtype``. The products the eager code folds from Python
    floats are folded here the same way, in float64; ``INV_<x>`` is ``1/x``
    in float64 (PyTorch's CUDA division of a tensor by a Python float
    multiplies by that reciprocal, rounded once to the tensor's dtype). The
    tail probabilities are the values the eager step forms from its tensors
    of ``dtype``, rounded as it rounds them."""
    ice = mp.ice
    p3 = ice.scheme
    aps = mp.warm_rain.air_properties
    vel = ice.terminal_velocity
    pdf_c, pdf_r = ice.cloud_pdf, ice.rain_pdf
    eps = machine_eps(dtype)
    pi = math.pi

    v = K2M._param_values(mp, tps, dtype)
    # the second blocks: the ice rain PSD and the ice Chen rain coefficients
    ice_rain = K2M.rain_pdf_values(pdf_r)
    ice_chen = K2M.chen_rain_values(vel.rain)
    for name, src in zip(ICE_RAIN_PDF_NAMES, _RAIN_PDF_BLOCK):
        v[name] = ice_rain[src]
    for name, src in zip(ICE_CHEN_NAMES, _CHEN_BLOCK):
        v[name] = ice_chen[src]

    # probabilities as the eager step rounds them in dtype: the ice bounds'
    # p and 1 - p are tensors of it (ops/p3.py:integral_bounds), the cloud
    # bounds' 1 - p is taken of a tensor of it (ops/m2.py)
    r = _NP[dtype]
    one = r(1.0)
    ib_p_lo = r(1e-6)
    ib_p_hi = r(1 - 1e-6)
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
        TWO_EPS=2 * eps, BIG=float(torch.finfo(dtype).max), GI_TINY=1e-30,
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
        AREA_SIGMA=p3.area.sigma, **_slope_values(p3.slope),
        P3_T_FREEZE=p3.T_freeze,
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


@trace.timed("setup.params_s")
def kernel_params_p3(mp, tps: ThermodynamicsParameters,
                     device: torch.device | str | None = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's parameter buffer for states of ``dtype`` (float32 or
    float64), on ``device``: the scalars in :data:`PARAM_NAMES` order, then
    the node/weight tables, each folded in float64 and rounded once to
    ``dtype``."""
    _build.check_dtype(dtype, "P3")
    values = _param_values_p3(mp, tps, dtype)
    if set(values) != set(PARAM_NAMES):
        raise AssertionError(
            "kernel parameter list out of sync: "
            f"{sorted(set(values) ^ set(PARAM_NAMES))}")
    scalars = np.array([float(values[n]) for n in PARAM_NAMES], np.float64)
    buf = np.concatenate([scalars, _tables(mp)])
    return torch.tensor(buf, dtype=torch.float64, device=device).to(dtype)


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
# Builds: one library per variant
# ---------------------------------------------------------------------------

class Variant(NamedTuple):
    """What one build of the source is for: the state's dtype, the ice
    quadrature order, and the P3 options that change the code."""

    dtype: str = "float32"
    order: int = 16
    slope_constant: bool = False    # SlopeConstant, else SlopePowerLaw
    oblate: bool = True             # the Oblate aspect ratio, else none
    ice_rain_limited: bool = True   # mp.ice.rain_pdf.is_limited

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def tag(self) -> str:
        """A short name: ``f32 GL-16``, ``f64 CG-100 SlopeConstant`` ..."""
        from ..utils.quadrature import build_quadrature

        rule = type(build_quadrature(self.order)).__name__
        parts = [{"float32": "f32", "float64": "f64"}[self.dtype],
                 f"{'GL' if rule == 'GaussLegendre' else 'CG'}-{self.order}"]
        if self.slope_constant:
            parts.append("SlopeConstant")
        if not self.oblate:
            parts.append("NoAspectRatio")
        if not self.ice_rain_limited:
            parts.append("unlimited ice rain PSD")
        return " ".join(parts)


DEFAULT_VARIANT = Variant()

# Columns a step's blocks are planned for by default (launch_plan): K5c
# steps the largest divisor that fits its block.
BLOCK_COLS = 128


def variant(mp, dtype: torch.dtype = torch.float32) -> Variant:
    """The build a step of ``mp`` on a state of ``dtype`` launches."""
    scheme = mp.ice.scheme
    return Variant(str(dtype).removeprefix("torch."), int(mp.ice.quad.n),
                   isinstance(scheme.slope, SlopeConstant),
                   scheme.aspect_ratio == OBLATE,
                   bool(mp.ice.rain_pdf.is_limited))


SOURCE = "column_p3.cu"
# nvcc flags of each build of the source: the one the wrappers launch
# (-lineinfo leaves the code as it is and maps each SASS instruction to its
# source line, which kernels/opcount.py reads) and the operation-count
# probe.
BUILDS = {
    "kernel": ("-lineinfo",),
    "probe": ("-lineinfo", "-DK5_PROBE"),
}
# the point-wise tendency builds of the source (-DK5_TEND) and their probe
TEND_BUILDS = {
    "tend": ("-lineinfo", "-DK5_TEND"),
    "tend_probe": ("-lineinfo", "-DK5_TEND", "-DK5_PROBE"),
}
_ALL_BUILDS = {**BUILDS, **TEND_BUILDS}


def header(v: Variant = DEFAULT_VARIANT) -> str:
    """The generated header of a build: ``#define P_<name> <index>`` of
    :data:`PARAM_NAMES`, ``N_PARAMS`` and the variant's macros (``K5_REAL``,
    ``K5_ORDER``, ``K5_SLOPE_CONSTANT``, ``K5_OBLATE``,
    ``K5_ICE_RAIN_LIMITED``)."""
    if v.order < 1:
        raise ValueError(f"a quadrature order is at least 1, not {v.order}")
    defines = (("K5_REAL", _build.c_type(v.torch_dtype)),
               ("K5_ORDER", int(v.order)),
               ("K5_SLOPE_CONSTANT", int(v.slope_constant)),
               ("K5_OBLATE", int(v.oblate)),
               ("K5_ICE_RAIN_LIMITED", int(v.ice_rain_limited)))
    return _build.index_header(PARAM_NAMES, "COLUMN_P3_PARAMS_H", defines)


def _flags(v: Variant, build: str) -> tuple:
    return _ALL_BUILDS[build] + _build.dtype_flags(v.torch_dtype)


def library_path(build: str = "kernel", v: Variant = DEFAULT_VARIANT):
    """The file of one of the kernel library's :data:`BUILDS` or
    :data:`TEND_BUILDS` for variant ``v`` (built if needed)."""
    return _build.build(SOURCE, "column_p3_params.h", header(v), _flags(v, build))


def probe_unrolls(v: Variant = DEFAULT_VARIANT) -> dict:
    """The unroll factors the source's ``K5_COUNT`` sites name by constant,
    as variant ``v`` sets them (``kernels/opcount.probe_sites``)."""
    return {"kGiUnroll": 2 if v.dtype == "float64" else 4}


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
    ice_nodes: int            # K5b: 4 x order ice nodes a cell
    node_passes: int          # K5b: lane passes a cell (node_passes)
    epilogue_cols: int        # K5c: whole columns per block
    epilogue_levels: int      # K5c: levels of a column per chunk
    epilogue_block: int       # K5c threads per block (cols * levels)
    epilogue_grid: int


def lanes_per_cell(order: int) -> int:
    """K5b's lanes per cell: one per ice node (4 segments x ``order``
    nodes) when they divide a warp, else a warp, which walks the nodes in
    chunks of 32 (the last one ragged)."""
    nodes = 4 * order
    return nodes if nodes <= 32 and 32 % nodes == 0 else 32


def node_chunks(order: int, dtype: torch.dtype = torch.float32
                ) -> tuple[int, int]:
    """K5b's walk over a cell's 4 x ``order`` ice nodes: (nodes per chunk,
    chunks). Each of the cell's :func:`lanes_per_cell` lanes takes up to
    two nodes a chunk at float32 and one at float64; the last chunk runs
    only the passes that hold a node (:func:`node_passes`), its lanes past
    the last node masked."""
    nodes, lanes = 4 * order, lanes_per_cell(order)
    per = min(-(-nodes // lanes), 2 if dtype == torch.float32 else 1)
    return per * lanes, -(-nodes // (per * lanes))


def node_passes(order: int, dtype: torch.dtype = torch.float32) -> int:
    """K5b's lane passes a cell: a pass for each node a lane takes in a
    chunk of :func:`node_chunks`, but in the last chunk only the passes
    that hold a node, so that no pass evaluates only nodes that are not
    summed. A pass is :func:`lanes_per_cell` lane-node evaluations."""
    chunk, chunks = node_chunks(order, dtype)
    lanes = lanes_per_cell(order)
    last = 4 * order - (chunks - 1) * chunk
    return (chunks - 1) * (chunk // lanes) + -(-last // lanes)


def launch_plan(ncol: int, nlev: int, order: int, block_cols: int,
                dtype: torch.dtype = torch.float32) -> LaunchPlan:
    """The launch plan of one K5 step on ``(ncol, nlev)`` fields of
    ``dtype`` at quadrature ``order``. ``block_cols`` must divide ``ncol``;
    K5c's block steps the largest divisor of ``block_cols`` whose columns
    fit in EPILOGUE_THREADS threads (so that the blocks fill the card
    however large ``block_cols`` is), each walked in chunks of at most
    EPILOGUE_THREADS levels."""
    _build.check_tiling(ncol, block_cols)
    if nlev < 1 or order < 1:
        raise ValueError(f"the CUDA P3 column kernel needs nlev >= 1 and a "
                         f"quadrature order >= 1, got {nlev} and {order}")
    ncells = ncol * nlev
    lanes = lanes_per_cell(order)
    per_block = NODE_THREADS // lanes
    levels = min(nlev, EPILOGUE_THREADS)
    fit = EPILOGUE_THREADS // levels
    cols = max(d for d in range(1, min(block_cols, fit) + 1)
               if block_cols % d == 0)
    return LaunchPlan(
        scratch_shape=(len(SCRATCH_FIELDS), ncells),
        solve_grid=-(-ncells // SOLVE_THREADS),
        nodes_grid=-(-ncells // per_block),
        lanes_per_cell=lanes, cells_per_block=per_block,
        ice_nodes=4 * order, node_passes=node_passes(order, dtype),
        epilogue_cols=cols, epilogue_levels=levels,
        epilogue_block=cols * levels, epilogue_grid=ncol // cols)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library(build: str = "kernel", v: Variant = DEFAULT_VARIANT
             ) -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS` for variant ``v``, loaded
    and bound (:func:`_build.library`)."""
    return _build.library(SOURCE, build, v, lambda: library_path(build, v),
                          lambda lib: _bind(lib, build, v))


def _bind(lib: ctypes.CDLL, build: str, v: Variant) -> ctypes.CDLL:
    """Set the C signatures of a loaded build of the source for variant
    ``v`` and check it against this module; returns it."""
    _F = _build.c_scalar(v.torch_dtype)
    if build in TEND_BUILDS:
        lib.column_p3_tend_bounds.argtypes = [_P, _P, _P, _P, _L, _I, _I, _P]
        lib.column_p3_tend_rates.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I,
                                             _I, _I, _P]
        lib.column_p3_nodes.argtypes = [_P, _P, _P, _P, _L, _I, _I, _P]
        launchers = (lib.column_p3_tend_bounds, lib.column_p3_tend_rates,
                     lib.column_p3_tend_rates_count)
    else:
        lib.column_p3_solve.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I, _P]
        lib.column_p3_epilogue.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _F, _F, _I, _I, _I, _P]
        lib.column_p3_nodes.argtypes = [_P, _P, _P, _L, _I, _I, _P]
        launchers = (lib.column_p3_solve, lib.column_p3_epilogue)
    # whether its K5b takes the int64 it adds the cells it ran to
    lib.counts_node_cells = build in TEND_BUILDS
    for fn in launchers + (lib.column_p3_nodes, lib.column_p3_num_params,
               lib.column_p3_scratch_fields, lib.column_p3_lanes_per_cell,
               lib.column_p3_node_chunk, lib.column_p3_node_chunks,
               lib.column_p3_node_passes, lib.column_p3_table_len):
        fn.restype = _I
    lib.column_p3_threads.argtypes, lib.column_p3_threads.restype = [_I], _I
    lib.column_p3_kernel_attrs.argtypes = [_I, _P]
    lib.column_p3_kernel_attrs.restype = _I
    lib.column_p3_variant.argtypes, lib.column_p3_variant.restype = [_P], _I
    if build in ("probe", "tend_probe"):
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
    built = (ctypes.c_int * 5)()
    lib.column_p3_variant(built)
    want = (v.torch_dtype.itemsize, v.order, int(v.slope_constant),
            int(v.oblate), int(v.ice_rain_limited))
    if tuple(built) != want:
        raise RuntimeError(f"column_p3 library built for {tuple(built)}, "
                           f"not the variant {want}")
    if (lib.column_p3_table_len() != _table_len(v.order)
            or lib.column_p3_lanes_per_cell() != lanes_per_cell(v.order)
            or (lib.column_p3_node_chunk(), lib.column_p3_node_chunks())
            != node_chunks(v.order, v.torch_dtype)
            or lib.column_p3_node_passes() != node_passes(v.order,
                                                          v.torch_dtype)):
        raise RuntimeError("column_p3 library built with other quadrature "
                           "tables or node chunks")
    if build in TEND_BUILDS and (lib.column_p3_tend_rates_count()
                                 != len(TEND_FIELDS)):
        raise RuntimeError("column_p3 tendency library built with another "
                           "list of rates")
    return lib


def kernel_attrs(lib: ctypes.CDLL) -> dict:
    """Registers, local memory bytes per thread, static shared memory
    bytes and the largest block of K5a, K5b and K5c of a loaded library,
    as the CUDA runtime reports them."""
    out = {}
    for k, name in enumerate(("K5a", "K5b", "K5c")):
        vals = (ctypes.c_int * 4)()
        err = lib.column_p3_kernel_attrs(k, vals)
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
    """Raise ``NotImplementedError`` for what the JAX step cannot run
    either: no P3 ice parameters, ice nucleation other than
    ``Frostenberg2023`` (the step's nucleation code reads that scheme's
    fields), a dtype other than float32 and float64, a rain velocity type
    the 2M step does not take, a slope law neither package knows."""
    ice = getattr(mp, "ice", None)
    if ice is None:
        raise NotImplementedError(
            "the CUDA P3 column kernel needs the P3 ice parameters (mp.ice)")
    _build.check_dtype(dtype, "P3")
    K2M.check_warm_rain(mp, nlev, dtype)
    if not isinstance(ice.ice_nucleation, Frostenberg2023):
        raise NotImplementedError(
            "the CUDA P3 column kernel supports Frostenberg2023 ice "
            f"nucleation, not {type(ice.ice_nucleation).__name__}")
    if not isinstance(ice.scheme.slope, (SlopePowerLaw, SlopeConstant)):
        raise NotImplementedError(
            f"unknown slope law {type(ice.scheme.slope).__name__}")


def _device_params(params, mp, tps, device, dtype) -> torch.Tensor:
    n = len(PARAM_NAMES) + _table_len(mp.ice.quad.n)
    if params is None:
        return kernel_params_p3(mp, tps, device=device, dtype=dtype)
    if (params.device != device or params.dtype != dtype
            or params.shape != (n,) or not params.is_contiguous()):
        raise ValueError(
            f"params must be a contiguous {dtype} ({n},) tensor on {device}")
    return params


def _ptrs(tensors) -> ctypes.c_void_p:
    arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    return ctypes.cast(arr, ctypes.c_void_p)


def launch_solve(lib, state, guess, loglam, scratch, params, plan, device):
    """K5a on the current stream: ``loglam`` and the first rows of
    ``scratch`` from ``state`` (and the warm-start ``guess`` or None)."""
    _build.launch(lib.column_p3_solve, _ptrs(state),
                  None if guess is None else guess.data_ptr(),
                  loglam.data_ptr(), scratch.data_ptr(), params.data_ptr(),
                  state.rho.numel(), plan.solve_grid, device.index,
                  torch.cuda.current_stream(device).cuda_stream,
                  span="launch.k5a", counter="launch_solve")


def launch_nodes(lib, state, scratch, params, plan, device, ran=None):
    """K5b on the current stream: the node-pass sums of ``scratch``. A
    tendency build's skips the warps whose cells hold no ice, leaving their
    rows of sums unwritten, and adds the cells whose node pass ran to
    ``ran``, an int64 0-d tensor on ``device`` (None: a fresh one, which
    nothing reads); the column build's takes no ``ran``."""
    cells = state.rho.numel()
    counted = ()
    if lib.counts_node_cells:
        if ran is None:
            ran = torch.zeros((), dtype=torch.int64, device=device)
        counted = (ran.data_ptr(),)
    _build.launch(lib.column_p3_nodes, _ptrs(state), scratch.data_ptr(),
                  params.data_ptr(), *counted, cells, plan.nodes_grid,
                  device.index, torch.cuda.current_stream(device).cuda_stream,
                  span="launch.k5b", counter="launch_nodes")
    trace.count("k5b.node_evals",
                cells * plan.lanes_per_cell * plan.node_passes)
    trace.count("k5b.nodes", cells * plan.ice_nodes)


def launch_epilogue(lib, state, out, scratch, params, plan, dt, dz, warm,
                    device):
    """K5c on the current stream: the eleven fields of ``out``; ``warm``:
    the warm rain's ``(is_limited, chen)`` variant."""
    ncol, nlev = state.rho.shape
    limited, chen = warm
    _build.launch(lib.column_p3_epilogue, _ptrs(state), _ptrs(out),
                  scratch.data_ptr(), params.data_ptr(), ncol, nlev,
                  plan.epilogue_cols, plan.epilogue_levels,
                  plan.epilogue_grid, float(dt), float(dz), limited, chen,
                  device.index, torch.cuda.current_stream(device).cuda_stream,
                  span="launch.k5c", counter="launch_epilogue")


def _check_fields(state, loglambda_guess, block_cols, where):
    return _build.check_fields(
        list(state) + ([] if loglambda_guess is None else [loglambda_guess]),
        block_cols, where)


def loglambda_p3_fused(state: ColumnStateP3, mp, tps, loglambda_guess=None,
                       params=None):
    """K5a alone: the P3 shape solve's ``(ncol, nlev)`` log lambda, warm-
    started from ``loglambda_guess`` when given. CPU tensors take
    :func:`loglambda_p3_plain`."""
    device = _check_fields(state, loglambda_guess, 1, "loglambda_p3_fused")
    if device is None:
        return loglambda_p3_plain(state, mp, loglambda_guess)
    with trace.span("column.prepare"):
        ncol, nlev = state.rho.shape
        dtype = state.rho.dtype
        _check_supported(mp, nlev, dtype)
        plan = launch_plan(ncol, nlev, mp.ice.quad.n, 1, dtype)
        params = _device_params(params, mp, tps, device, dtype)
        lib = _library("kernel", variant(mp, dtype))
        loglam = torch.empty_like(state.rho)
        scratch = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
    with _build.launching(lib):
        launch_solve(lib, state, loglambda_guess, loglam, scratch, params,
                     plan, device)
    return loglam


def step_column_p3_fused(state: ColumnStateP3, mp, tps, dt, dz,
                         loglambda_guess=None,
                         block_cols: int = BLOCK_COLS, params=None):
    """One 2M + P3 column step on eleven ``(ncol, nlev)`` fields; returns
    ``(new_state, loglambda)`` like :func:`step_column_p3`.

    On CUDA tensors it launches K5a (shape solve and bounds), K5b (ice node
    pass) and K5c (rates, sedimentation, update) of the build for
    :func:`variant` on the current stream, joined by a
    ``(len(SCRATCH_FIELDS), ncol * nlev)`` scratch record of the state's
    dtype it allocates (see :func:`launch_plan`). ``loglambda_guess``: an
    optional ``(ncol, nlev)`` warm start for the shape solve (the previous
    step's ``loglambda``). ``ncol`` must be a multiple of ``block_cols``.
    ``params``: the buffer of :func:`kernel_params_p3` for the state's
    dtype, built here when not given. CPU tensors take
    :func:`step_column_p3_plain`.
    """
    device = _check_fields(state, loglambda_guess, block_cols,
                           "step_column_p3_fused")
    if device is None:
        return step_column_p3_plain(state, mp, tps, dt, dz, loglambda_guess)
    with trace.span("column.prepare"):
        ncol, nlev = state.rho.shape
        dtype = state.rho.dtype
        _check_supported(mp, nlev, dtype)
        plan = launch_plan(ncol, nlev, mp.ice.quad.n, block_cols, dtype)
        params = _device_params(params, mp, tps, device, dtype)
        lib = _library("kernel", variant(mp, dtype))
        warm = warm_variant(mp)
        out = ColumnStateP3(*(torch.empty_like(t) for t in state))
        loglam = torch.empty_like(state.rho)
        scratch = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
    with _build.launching(lib):
        launch_solve(lib, state, loglambda_guess, loglam, scratch, params,
                     plan, device)
        launch_nodes(lib, state, scratch, params, plan, device)
        launch_epilogue(lib, state, out, scratch, params, plan, dt, dz,
                        warm, device)
    trace.count("launches.step_column_p3_fused")
    return out, loglam


# ---------------------------------------------------------------------------
# The point-wise fused tendencies: the -DK5_TEND builds
# ---------------------------------------------------------------------------

# the rates a tendency call writes, in Tendencies2M's order (kRates in
# csrc/column_p3.cu)
TEND_FIELDS = BMT.Tendencies2M._fields
# the counter of the points whose node pass a tendency call ran: every
# point of a K5b warp that holds ice (trace.device_counter)
ICE_POINTS = "tendencies.ice_points"

# the parameter buffers of the last few (mp, tps, device, dtype) a tendency
# call met, so that a host calling every step builds its buffer once
_TEND_PARAMS = {}
_TEND_PARAMS_KEPT = 8


def _tend_params(mp, tps, device, dtype) -> torch.Tensor:
    key = (mp, tps, device, dtype)
    buf = _TEND_PARAMS.get(key)
    if buf is None:
        if len(_TEND_PARAMS) >= _TEND_PARAMS_KEPT:
            _TEND_PARAMS.pop(next(iter(_TEND_PARAMS)))
        buf = _TEND_PARAMS[key] = kernel_params_p3(mp, tps, device=device,
                                                   dtype=dtype)
    return buf


def tracked(t) -> bool:
    """Whether autograd, forward-mode AD or a ``torch.func`` transform
    tracks the tensor ``t`` (the tendency kernels track none)."""
    return ((torch.is_grad_enabled() and t.requires_grad)
            or is_functorch_wrapped_tensor(t)
            or fwAD.unpack_dual(t).tangent is not None)


def tend_inputs(fields):
    """``(inputs, shift)``: the twelve tensors a tendency launch reads (the
    eleven of ``ColumnStateP3`` and log lambda) and the INP log shift (or
    None), from ``bulk_tendencies_2m``'s ``fields`` ``(rho, ..., b_rim,
    log_lambda, inpc_log_shift)``, each a contiguous CUDA tensor of the
    fields' broadcast shape, device and dtype: what the eager code makes
    of them. A field None is zeros (a shift None stays None, a zero shift);
    a Python number (which the eager code takes for log lambda and the
    shift) is that value in the dtype; a tensor of another shape or layout
    is expanded and made contiguous.

    The device and dtype are those of the first CUDA tensor; every tensor
    lies there in that dtype, 0-d ones too (eager arithmetic on a 0-d
    tensor alone runs in its own dtype and on its own device, which the
    kernels cannot repeat). Raises ``NotImplementedError`` for a
    field that a derivative tracks (:func:`tracked`) and for a dtype the
    kernels are not built for, ``ValueError`` when no field lies on a CUDA
    device, for a tensor on another device or of another dtype and for
    shapes that do not broadcast, ``TypeError`` for what is neither a
    tensor nor a Python number."""
    tensors = [t for t in fields if isinstance(t, torch.Tensor)]
    if any(tracked(t) for t in tensors):
        raise NotImplementedError(
            "the CUDA P3 tendency kernels track no derivative: call "
            "bulk_tendencies_2m_plain to differentiate (log lambda held "
            "fixed), or launch under torch.no_grad()")
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        raise ValueError("p3_tendencies_fused launches on CUDA fields; CPU "
                         "fields take bulk_tendencies_2m_plain")
    device, dtype = cuda[0].device, cuda[0].dtype
    _build.check_dtype(dtype, "P3")
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(
                f"p3_tendencies_fused: fields differ in device or dtype "
                f"({t.device} {t.dtype}, not {device} {dtype})")
    shape = broadcast_shape({tuple(t.shape) for t in tensors})
    zero = None

    def full(v):
        nonlocal zero
        if v is None:
            if zero is None:
                zero = torch.zeros(shape, dtype=dtype, device=device)
            return zero
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return torch.full(shape, float(v), dtype=dtype, device=device)
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"p3_tendencies_fused: a field is a tensor, a "
                            f"Python number or None, not {type(v).__name__}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            v = v.expand(shape).contiguous()
        return v

    inputs = [full(v) for v in fields[:-1]]
    shift = None if fields[-1] is None else full(fields[-1])
    _build.check_cuda(inputs + ([] if shift is None else [shift]),
                      "p3_tendencies_fused")
    return inputs, shift


def launch_tend_bounds(lib, fields, loglam, scratch, params, plan, device):
    """K5a of a tendency build on the current stream: the first rows of
    ``scratch`` from the flat ``fields`` and the input ``loglam``."""
    _build.launch(lib.column_p3_tend_bounds, _ptrs(fields),
                  loglam.data_ptr(), scratch.data_ptr(), params.data_ptr(),
                  fields.rho.numel(), plan.solve_grid, device.index,
                  torch.cuda.current_stream(device).cuda_stream,
                  span="launch.p3tend_bounds", counter="launch_tend_bounds")


def launch_tend_rates(lib, fields, shift, out, scratch, params, warm,
                      device):
    """K5c of a tendency build on the current stream: the rows of ``out``
    (:data:`TEND_FIELDS`) from the flat ``fields``, the INP log ``shift``
    (or None) and ``scratch``; ``warm``: the warm rain's ``(is_limited,
    chen)`` variant."""
    n = fields.rho.numel()
    limited, chen = warm
    _build.launch(lib.column_p3_tend_rates, _ptrs(fields),
                  None if shift is None else shift.data_ptr(), _ptrs(out),
                  scratch.data_ptr(), params.data_ptr(), n,
                  -(-n // EPILOGUE_THREADS), limited, chen, device.index,
                  torch.cuda.current_stream(device).cuda_stream,
                  span="launch.p3tend_rates", counter="launch_tend_rates")


def p3_tendencies_fused(mp, tps, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
                        q_ice=None, n_ice=None, q_rim=None, b_rim=None,
                        log_lambda=None, inpc_log_shift=None):
    """``bulk_tendencies_2m`` with P3 ice on CUDA fields: the eight rates as
    a :class:`..models.tendencies.Tendencies2M` of the fields' broadcast
    shape, for the given ``log_lambda`` (the host's shape solve, e.g.
    :func:`loglambda_p3_fused`; None: 0) and per-point ``inpc_log_shift``
    (None: 0), bit for bit what :func:`..models.tendencies.
    bulk_tendencies_2m_plain` gives on them.

    It launches K5a (sanitized state, bounds, factors; no solve), K5b and
    the rates kernel of the tendency build of :func:`variant` on the
    current stream, the fields viewed flat (:func:`tend_inputs` makes them
    so), joined by a scratch record it allocates; the parameter buffer is
    the one built at the first call with the same parameters, device and
    dtype (the last few are kept)."""
    inputs, shift = tend_inputs((rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
                                 q_ice, n_ice, q_rim, b_rim, log_lambda,
                                 inpc_log_shift))
    shape, device, dtype = inputs[0].shape, inputs[0].device, inputs[0].dtype
    n = inputs[0].numel()
    _check_supported(mp, 1, dtype)
    out = torch.empty((len(TEND_FIELDS), n), dtype=dtype, device=device)
    if n:
        plan = launch_plan(n, 1, mp.ice.quad.n, 1, dtype)
        params = _tend_params(mp, tps, device, dtype)
        lib = _library("tend", variant(mp, dtype))
        flat = ColumnStateP3(*(t.reshape(-1) for t in inputs[:-1]))
        loglam = inputs[-1].reshape(-1)
        scratch = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
        with _build.launching(lib):
            launch_tend_bounds(lib, flat, loglam, scratch, params, plan,
                               device)
            launch_nodes(lib, flat, scratch, params, plan, device,
                         trace.device_counter(ICE_POINTS, device))
            launch_tend_rates(lib, flat, None if shift is None
                              else shift.reshape(-1), out, scratch, params,
                              warm_variant(mp), device)
        trace.count("launches.p3_tendencies_fused")
    return BMT.Tendencies2M(*(r.view(shape) for r in out))
