// Fused 1-moment column step: one explicit-Euler step of the 18 1M source
// terms, upwind sedimentation of cloud liquid, cloud ice, rain and snow,
// and the latent-heat temperature update, over (ncol, nlev) columns.
//
// Scope: everything models/column.py:step_column_1m takes, each a build of
// this source: the scalar type (float or double, K1_REAL of the generated
// header; the cells compute on `real`, real.cuh's uncontracted Dbl for
// double); the tendency mode, instantaneous or linearized_average
// (K1_LINEARIZED: `nsub` linearized implicit substeps per cell, the 2x2
// block solves of models/tendencies.py, with nsub a launch argument); and
// the process options of Microphysics1MOptions, one macro per slot
// (K1_OPT_<SLOT>: 0 for a disabled process, 1 for the default option, 2 for
// the alternative: TemperatureDependent cloud ice formation, PrescribedNd
// rain autoconversion, WithSupersaturation snow autoconversion,
// SublimationOnly snow deposition). A disabled process contributes the
// eager step's zero to the same sums, so the rounding is the eager step's.
//
// Replaces the two Pallas TPU kernels of cloudmicrophysics_tpu/kernels/
// column1m.py: step_column_1m_pallas_packed (one (7, ncol, nlev) buffer in
// and out) and step_column_1m_pallas (seven (ncol, nlev) buffers in and
// out). One __global__ body serves both; the two C entry points differ
// only in how they fill the seven field pointers.
//
// Rounding: each expression follows the eager PyTorch step's operation
// order as PyTorch's CUDA kernels evaluate it, so that the kernel is
// bit-identical to its plain version: `x / c` for a Python-float c is a
// multiply by c's reciprocal, taken in double on the host and rounded once
// to the build's type (the INV_* parameters; 1/3 is kThird), `c / x` is
// reciprocal(x) * c, and a division by a tensor stays an IEEE division. The
// logistic integral of the autoconversions divides by x0 and k, which the
// eager step holds as device tensors: those two stay IEEE divisions too.
// Built without fast math, with --fmad=false (float) or --fmad=true over
// uncontracted arithmetic (double; real.cuh says why). Each cell evaluates about
// 40 exp/log/pow/sqrt calls and 15 IEEE divisions; every intermediate stays
// in registers (one HBM read and one write per field).
//
// Parameters: the generated header defines each value of the parameter list
// as a literal of its exact value in the build's type (PC_<name>; a float64
// build's block holds the float64 constants of its dtype; the values of a
// process option not selected are 0 and not read), and the library is built
// once per parameter block, dtype, mode and option set. Every constant is
// then an immediate operand: no global load, no constant-bank load, no register to
// hold it, and branches on a parameter (tpow's exponent) are resolved when
// the kernel is compiled. Passed by value as a kernel argument instead, the
// constants reached the arithmetic through uniform registers loaded by
// ULDC, and the step took about a fifth longer (PERF.md).
//
// Layout: a warp steps whole columns, 32 levels at a time from the top chunk
// down; lane l of chunk c owns level 32 c + l, so each field's load and store
// of a warp is 128 contiguous bytes. A block's kWarps warps share its
// `block_cols` columns (warp w takes columns w, w + kWarps, ...). The flux of
// level k + 1 comes from the next lane by a shuffle; lane 31 takes lane 0's
// flux of the chunk above, carried from the previous iteration; the top
// level gets no inflow (levels above nlev carry zero flux). No barrier:
// warps are independent. Each warp's next chunk is copied into its own
// shared double buffer by cp.async while it steps the current one, so the
// copies are in flight during cell_step and hold no registers there; a lane
// reads back only its own slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column1m_params.h"
#include "real.cuh"

#ifdef K1_PROBE
#define STAGE_PROBE
#endif
#include "stage_probe.cuh"

namespace {

using namespace rmath;
using scalar = K1_REAL;   // the build's dtype: float or double
using real = Real<scalar>::type;   // what the cells compute on (real.cuh)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// resident blocks per SM the registers are held to: the fastest setting
// without spills of k1_occupancy_sweep.py for the float32 instantaneous
// build (PERF.md); the float64 and linearized builds hold about twice the
// registers and take one block, which lets the compiler use 255
constexpr int kMinBlocks = 2;
constexpr bool kLinearized = K1_LINEARIZED != 0;
constexpr int kBuildMinBlocks = (sizeof(scalar) == 4 && !kLinearized) ? kMinBlocks : 1;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno
// (of the scalar type: device code reads a namespace-scope constexpr only
// of a scalar type; it converts to `real` where used)
constexpr scalar kThird = (scalar)(1.0 / 3.0);
constexpr scalar kNegLog2 = (scalar)-0.6931471805599453;
constexpr scalar kTiny = Limits<scalar>::tiny;  // torch.finfo(dtype).tiny

// the process options (Microphysics1MOptions), one code per slot
constexpr int kCloudLiquidFormation = K1_OPT_CLOUD_LIQUID_FORMATION;  // 1: CloudLiquidFormation
constexpr int kCloudIceFormation = K1_OPT_CLOUD_ICE_FORMATION;  // 1: ConstantTimescale, 2: TemperatureDependent
constexpr int kCloudIceMelt = K1_OPT_CLOUD_ICE_MELT;
constexpr int kRainAutoconversion = K1_OPT_RAIN_AUTOCONVERSION;  // 1: Kessler1M, 2: PrescribedNd
constexpr int kSnowAutoconversion = K1_OPT_SNOW_AUTOCONVERSION;  // 1: NoSupersaturation, 2: WithSupersaturation
constexpr int kRainEvaporation = K1_OPT_RAIN_CONDENSATION_EVAPORATION;
constexpr int kSnowDepSubl = K1_OPT_SNOW_DEPOSITION_SUBLIMATION;  // 1: DepositionAndSublimation, 2: SublimationOnly
constexpr int kSnowMelt = K1_OPT_SNOW_MELT;
constexpr int kAccrLcrRai = K1_OPT_CLOUD_LIQUID_RAIN_ACCRETION;
constexpr int kAccrLclSno = K1_OPT_CLOUD_LIQUID_SNOW_ACCRETION;
constexpr int kAccrIclRai = K1_OPT_CLOUD_ICE_RAIN_ACCRETION;
constexpr int kAccrIclSno = K1_OPT_CLOUD_ICE_SNOW_ACCRETION;
constexpr int kAccrRaiSno = K1_OPT_RAIN_SNOW_ACCRETION;

struct Fields {
  const real* in[kFields];
  real* out[kFields];
};

// the substeps of linearized_average: dt / nsub, its reciprocal and 1 / dt,
// each taken in double on the host and rounded once to `real`, as the
// eager step's Python floats are
struct Substeps {
  int nsub;
  real dt_sub, inv_dt_sub, inv_dt;
};

#define PV(name) (PC_##name)

// max/min that return `a` when it is NaN, as torch.clamp does
__device__ __forceinline__ real maxf(real a, real b) { return a < b ? b : a; }
__device__ __forceinline__ real minf(real a, real b) { return b < a ? b : a; }
// torch.minimum: NaN from either argument
__device__ __forceinline__ real tmin(real a, real b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// `c / x` for a Python scalar c and a tensor x is reciprocal(x) * c in torch
__device__ __forceinline__ real rdiv(real c, real x) { return (real(1) / x) * c; }

// torch.pow(x, p) for a scalar p: the small integer exponents are products
__device__ __forceinline__ real tpow(real x, real p) {
  if (p == real(2)) return x * x;
  if (p == real(3)) return x * x * x;
  if (p == real(0.5)) return sqrt_(x);
  return pow_(x, p);
}

// trnslt = -log1mexp(-k) / k of ops/common.py:logistic_function_integral, as
// the eager step evaluates it on the device
__device__ __forceinline__ real logistic_translation(real k) {
  const real x = -k;
  const real x_hi = minf(x, -kTiny);
  const real l = x > kNegLog2 ? log_(-expm1_(x_hi)) : log1p_(-exp_(x_hi));
  return -l / k;
}

// logistic_function_integral(x, x0, k) (ops/common.py) with x0_safe and k
// from the host and the translation from logistic_translation
__device__ __forceinline__ real logistic_integral(real x_in, real x0s, real k,
                                                  real trn, real x0_lt_eps,
                                                  real eps) {
  const real x = maxf(x_in, real(0));
  const real x_safe = maxf(x, eps);
  const real kt = k * (x_safe / x0s - real(1) + trn);
  // logaddexp(0, kt)
  const real lae = maxf(real(0), kt) + log1p_(exp_(-fabs_(real(0) - kt)));
  real result = (lae / k - trn) * x0s;
  result = x < eps ? real(0) : result;
  return x0_lt_eps != real(0) ? x : result;
}

// _relaxation_tendency (ops/noneq.py): the eager step divides both arms and
// selects one; dividing only the selected numerator by the selected
// timescale gives the same bits, with one division (one timescale: the
// selection of the divisor folds away)
__device__ __forceinline__ real relaxation(real sat_excess, real q_cond,
                                           real ts_dep, real ts_sub) {
  const real evap = -minf(-sat_excess, maxf(q_cond, real(0)));
  const bool sub = sat_excess < real(0);
  return (sub ? evap : sat_excess) / (sub ? ts_sub : ts_dep);
}

// _accretion_kernel (ops/m1.py), the same left-to-right product
__device__ __forceinline__ real accretion(real q_clo, real q_pre, real E,
                                          real n0, real a0, real v0,
                                          real chia, real chiv, real lam,
                                          real g, real pw, real eps) {
  real r = q_clo * E;
  r = r * n0;
  r = r * a0;
  r = r * v0;
  r = r * chia;
  r = r * chiv;
  r = r * lam;
  r = r * g;
  r = r * pw;
  return (q_clo > eps && q_pre > eps) ? r : real(0);
}

// the bracket of _accretion_snow_rain_kernel for collector i, species j
__device__ __forceinline__ real snow_rain_bracket(real lam_i, real lam_j,
                                                  real e1, real e2, real e3,
                                                  real c2, real c3) {
  const real t1 = (real(2) * (lam_i * lam_i * lam_i)) * tpow(lam_j, e1);
  const real t2 = (c2 * (lam_i * lam_i)) * tpow(lam_j, e2);
  const real t3 = (c3 * lam_i) * tpow(lam_j, e3);
  return t1 + t2 + t3;
}

// the Frostenberg 2023 deposition timescale of TemperatureDependent cloud
// ice formation (ops/noneq.py:tau_relax_frostenberg), q_icl clamped
__device__ __forceinline__ real tau_frostenberg(real q_icl, real T, real eps) {
  const real T_celsius = minf(T - PV(FR_T_FREEZE), real(0));
  const real arg = maxf(T_celsius * PV(FR_NEG_B) * PV(INV_TEN), kTiny);
  const real N_icl = exp_(log_(arg) * real(9) - PV(FR_LOG_A));
  const real safe_N = maxf(N_icl, eps);
  const real r = N_icl > eps
                     ? pow_((maxf(q_icl, real(0)) * real(3)) /
                                (safe_N * PV(PI4) * PV(RHO_I_ICL)),
                            kThird)
                     : real(0);
  const real r_safe = maxf(r, PV(FR_R_MIN));
  return real(1) / (N_icl * PV(C4PI_DV) * r_safe);
}

// The 18 source terms of one state (models/tendencies.py:
// microphysics_source_terms_1m, the size distribution computed from the
// state), with what the column step shares with them: the bulk fall speeds
// of rain and snow, the T-dependent latent heats, the moist heat capacity
// and the saturation vapor pressures.
struct Terms {
  real vap_lcl, vap_icl, acnv_lcl_rai, acnv_icl_sno, accr_lcl_rai;
  real accr_lcl_sno_cold, accr_lcl_sno_warm, accr_melt_lcl_sno;
  real accr_icl_rai, accr_freeze_icl_rai, accr_icl_sno;
  real accr_rai_sno_cold, accr_rai_sno_warm, accr_melt_rai_sno;
  real vap_rai, vap_sno, melt_icl_lcl, melt_sno_rai;
  real w_rai, w_sno;          // bulk terminal velocities
  real Lv, Ls, cp_air;        // latent heats at T, moist cp of the clamped state
  real p_sat_l, p_sat_i;      // saturation vapor pressures at T
};

// trn_r, trn_s: the autoconversions' logistic translations.
__device__ __forceinline__ Terms source_terms(real trn_r, real trn_s, real rho,
                                              real T, real q_tot, real q_lcl,
                                              real q_icl, real q_rai,
                                              real q_sno) {
  const real eps = PV(EPS);
  const real tiny = PV(TINY);
  const real log_eps = PV(LOG_EPS);
  Terms t;

  // clamped state (micro/thermo of step_column_1m and the source terms)
  const real rho_c = maxf(rho, real(0));
  const real qt_c = maxf(q_tot, real(0));
  const real ql_c = maxf(q_lcl, real(0));
  const real qi_c = maxf(q_icl, real(0));
  const real qr_c = maxf(q_rai, real(0));
  const real qs_c = maxf(q_sno, real(0));

  // ---- size_distr_parameters (ops/m1.py), in shared log space ----------
  // (the eager step clamps the clamped fields to 0 once more: maxf(x_c, 0)
  // is x_c bit for bit, NaN and -0 included)
  const real log_rho = log_(maxf(rho_c, tiny));
  const real log_qr = log_(maxf(qr_c, tiny));
  const real log_qs = log_(maxf(qs_c, tiny));
  const real log_qi = log_(maxf(qi_c, tiny));

  const real log_n0s_raw =
      PV(LOG_MU_SNO) + PV(NU_SNO) * (log_rho + maxf(log_qs, log_eps));
  const bool sno_present = qs_c > eps;
  const real n0_sno = sno_present ? exp_(log_n0s_raw) : real(0);
  const real log_n0_sno = sno_present ? maxf(log_n0s_raw, log_eps) : log_eps;

  real log_lam_rai =
      PV(POW_RAI) * (log_qr + log_rho + PV(LOGNUM_RAI) - PV(LOGDEN_RAI));
  log_lam_rai = qr_c > tiny ? log_lam_rai : PV(HALF_MIN);
  log_lam_rai = maxf(log_lam_rai, PV(LOGFLOOR_RAI));
  real log_lam_sno = PV(POW_SNO) *
                     (log_qs + log_rho + PV(LOGNUM_SNO) - (PV(LOGC_SNO) + log_n0_sno));
  log_lam_sno = qs_c > tiny ? log_lam_sno : PV(HALF_MIN);
  log_lam_sno = maxf(log_lam_sno, PV(LOGFLOOR_SNO));
  real log_lam_icl =
      PV(POW_ICL) * (log_qi + log_rho + PV(LOGNUM_ICL) - PV(LOGDEN_ICL));
  log_lam_icl = qi_c > tiny ? log_lam_icl : PV(HALF_MIN);
  log_lam_icl = maxf(log_lam_icl, PV(LOGFLOOR_ICL));

  const real lam_rai = exp_(log_lam_rai);
  const real lam_sno = exp_(log_lam_sno);
  const real lam_icl = exp_(log_lam_icl);

  const real dens = maxf(rdiv(PV(RHO_W_VEL_RAI), rho_c) - real(1), real(0));
  const real v0_rai = sqrt_(PV(V0C_RAI) * dens * PV(GRAV_VEL_RAI) * PV(R0_VEL_RAI));

  // ---- thermodynamics shared by the rates (ops/thermo.py) --------------
  const real dT0 = T - PV(T_0);
  const real Lv = PV(LH_V0) + PV(DCP_VL) * dT0;
  const real Ls = PV(LH_S0) + PV(DCP_VI) * dT0;
  const real Lf = PV(LH_F0) + PV(DCP_LI) * dT0;
  const real q_liq = ql_c + qr_c;
  const real q_ice = qi_c + qs_c;
  const real cp_air = PV(CP_D) + PV(CPVD) * qt_c + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
  const real qv = maxf(qt_c - q_liq - q_ice, real(0));
  const real log_T = log_(T * PV(INV_T_TRIPLE));
  const real inv_T = real(1) / T;
  const real dinv_T = PV(INV_T_TRIPLE) - inv_T;
  const real p_sat_l = PV(PRESS_TRIPLE) * exp_(PV(KV_L) * log_T + PV(CL_L) * dinv_T);
  const real p_sat_i = PV(PRESS_TRIPLE) * exp_(PV(KV_I) * log_T + PV(CL_I) * dinv_T);
  const real rho_Rv_T = rho_c * PV(R_V) * T;
  const real qv_sat_l = p_sat_l / rho_Rv_T;
  const real qv_sat_i = p_sat_i / rho_Rv_T;
  const real Rv_T2 = (T * T) * PV(R_V);
  const bool is_warm = T >= PV(T_FREEZE);
  t.Lv = Lv;
  t.Ls = Ls;
  t.cp_air = cp_air;
  t.p_sat_l = p_sat_l;
  t.p_sat_i = p_sat_i;

  // ---- cloud condensate formation (ops/noneq.py) -----------------------
  t.vap_lcl = real(0);
  if (kCloudLiquidFormation) {
    const real dqdT_l = qv_sat_l * (Lv / Rv_T2 - inv_T);
    const real ts_l = PV(TAU_LCL) * (real(1) + (Lv / cp_air) * dqdT_l);
    t.vap_lcl = relaxation(qv - qv_sat_l, ql_c, ts_l, ts_l);
  }

  t.vap_icl = real(0);
  if (kCloudIceFormation) {
    const real dqdT_i = qv_sat_i * (Ls / Rv_T2 - inv_T);
    const real ts_i = PV(TAU_ICL) * (real(1) + (Ls / cp_air) * dqdT_i);
    // TemperatureDependent: the Frostenberg timescale for deposition
    const real ts_dep = kCloudIceFormation == 2
                            ? tau_frostenberg(qi_c, T, eps) * (real(1) + (Ls / cp_air) * dqdT_i)
                            : ts_i;
    real S = relaxation(qv - qv_sat_i, qi_c, ts_dep, ts_i);
    t.vap_icl = (T > PV(T_FREEZE) && S > real(0)) ? real(0) : S;
  }

  // ---- vapor over ice: shared by snow autoconversion and deposition ----
  const real p_v = qv * rho_c * PV(R_V) * T;
  const real S_ice = p_v / p_sat_i - real(1);
  const real G_ice = real(1) / (Ls * PV(INV_K_THERM_SAFE) / T *
                                    (Ls * PV(INV_R_V) / T - real(1)) +
                                T * PV(R_V) * PV(INV_D_VAPOR_SAFE) / maxf(p_sat_i, eps));

  // ---- autoconversion --------------------------------------------------
  t.acnv_lcl_rai = real(0);
  if (kRainAutoconversion == 1)
    t.acnv_lcl_rai = logistic_integral(ql_c, PV(ACNV_R_X0S), PV(ACNV_R_K), trn_r,
                                       PV(ACNV_R_X0LT), eps) * PV(INV_ACNV_R_TAU);
  if (kRainAutoconversion == 2)  // PrescribedNd: q_lcl / (tau (Nc/1e8)^alpha)
    t.acnv_lcl_rai = maxf(ql_c, real(0)) * PV(INV_ACNV_PND);
  t.acnv_icl_sno = real(0);
  if (kSnowAutoconversion == 1)
    t.acnv_icl_sno = logistic_integral(qi_c, PV(ACNV_S_X0S), PV(ACNV_S_K), trn_s,
                                       PV(ACNV_S_X0LT), eps) * PV(INV_ACNV_S_TAU);
  if (kSnowAutoconversion == 2) {  // WithSupersaturation
    real r = S_ice * PV(PI4);
    r = r * G_ice;
    r = r * PV(N0_ICL);
    r = r / rho_c;
    r = r * exp_(rdiv(PV(NEG_R_IS), lam_icl));
    r = r * ((rdiv(PV(R_IS), lam_icl) + real(1)) * (lam_icl * lam_icl) + PV(R_IS2_DELTA));
    t.acnv_icl_sno = (qi_c > eps && S_ice > real(0) && T < PV(T_FREEZE)) ? r : real(0);
  }

  // ---- accretion -------------------------------------------------------
  const real pw_accr_rai = exp_(PV(PACC_RAI) * (log_lam_rai - PV(LOG_R0_RAI)));
  const real pw_accr_sno = exp_(PV(PACC_SNO) * (log_lam_sno - PV(LOG_R0_SNO)));

  t.accr_lcl_rai = real(0);
  if (kAccrLcrRai)
    t.accr_lcl_rai = accretion(ql_c, qr_c, PV(E_LR), PV(N0_RAI), PV(A0_RAI), v0_rai,
                               PV(CHIA_RAI), PV(CHIV_RAI), lam_rai, PV(GACC_RAI),
                               pw_accr_rai, eps);
  const real alpha_melt =
      T <= PV(T_FREEZE) ? real(0) : rdiv(PV(CV_L), Lf) * (T - PV(T_FREEZE));
  t.accr_lcl_sno_cold = t.accr_lcl_sno_warm = t.accr_melt_lcl_sno = real(0);
  if (kAccrLclSno) {
    const real S_accr_ls =
        accretion(ql_c, qs_c, PV(E_LS), n0_sno, PV(A0_SNO), PV(V0_SNO),
                  PV(CHIA_SNO), PV(CHIV_SNO), lam_sno, PV(GACC_SNO), pw_accr_sno, eps);
    t.accr_lcl_sno_cold = is_warm ? real(0) : S_accr_ls;
    t.accr_lcl_sno_warm = is_warm ? S_accr_ls : real(0);
    t.accr_melt_lcl_sno = alpha_melt * S_accr_ls;
  }

  t.accr_icl_rai = t.accr_freeze_icl_rai = real(0);
  if (kAccrIclRai) {
    t.accr_icl_rai =
        accretion(qi_c, qr_c, PV(E_IR), PV(N0_RAI), PV(A0_RAI), v0_rai,
                  PV(CHIA_RAI), PV(CHIV_RAI), lam_rai, PV(GACC_RAI), pw_accr_rai, eps);
    // _accretion_rain_sink_kernel
    const real pw = exp_(PV(PSINK_RAI) * (log_lam_rai - PV(LOG_R0_RAI)));
    real r = rdiv(PV(E_IR), rho_c);
    r = r * PV(N0_RAI);
    r = r * PV(N0_ICL);
    r = r * PV(M0_RAI);
    r = r * PV(A0_RAI);
    r = r * v0_rai;
    r = r * PV(CHIM_RAI);
    r = r * PV(CHIA_RAI);
    r = r * PV(CHIV_RAI);
    r = r * lam_icl;
    r = r * lam_rai;
    r = r * PV(GSINK_RAI);
    r = r * pw;
    t.accr_freeze_icl_rai = (qi_c > eps && qr_c > eps) ? r : real(0);
  }
  t.accr_icl_sno = real(0);
  if (kAccrIclSno)
    t.accr_icl_sno =
        accretion(qi_c, qs_c, PV(E_IS), n0_sno, PV(A0_SNO), PV(V0_SNO),
                  PV(CHIA_SNO), PV(CHIV_SNO), lam_sno, PV(GACC_SNO), pw_accr_sno, eps);

  // bulk terminal velocities of rain and snow (power law), shared by the
  // rain-snow collisions and the sedimentation
  const real w_rai_raw = v0_rai * PV(CHIV_RAI) *
                         exp_(PV(PVT_RAI) * (log_lam_rai - PV(LOG_R0_RAI))) *
                         PV(GTERM_RAI) * PV(INV_GC_RAI);
  const real w_rai = qr_c > eps ? w_rai_raw : real(0);
  const real w_sno_raw = PV(CV0_SNO) *
                         exp_(PV(PVT_SNO) * (log_lam_sno - PV(LOG_R0_SNO))) *
                         PV(GTERM_SNO) * PV(INV_GC_SNO);
  const real w_sno = qs_c > eps ? w_sno_raw : real(0);
  t.w_rai = w_rai;
  t.w_sno = w_sno;

  t.accr_rai_sno_cold = t.accr_rai_sno_warm = t.accr_melt_rai_sno = real(0);
  if (kAccrRaiSno) {  // _accretion_snow_rain_kernel, both collision orders
    const bool both = qs_c > eps && qr_c > eps;
    const real cd = PV(CD_RS);
    const real d_sr = w_sno - w_rai;
    const real dv_sr = sqrt_(d_sr * d_sr + cd * (w_sno * w_sno + w_rai * w_rai));
    real r = rdiv(PV(PI), rho_c);
    r = r * n0_sno;
    r = r * PV(N0_RAI);
    r = r * PV(M0_RAI);
    r = r * PV(CHIM_RAI);
    r = r * PV(E_RS);
    r = r * dv_sr;
    r = r * PV(GC_RAI);
    r = r * PV(INV_R0D_RAI);
    r = r * snow_rain_bracket(lam_sno, lam_rai, PV(EXP1_RAI), PV(EXP2_RAI),
                              PV(EXP3_RAI), PV(C2_RAI), PV(C3_RAI));
    const real S_rai_sno = both ? r : real(0);

    const real d_rs = w_rai - w_sno;
    const real dv_rs = sqrt_(d_rs * d_rs + cd * (w_rai * w_rai + w_sno * w_sno));
    r = rdiv(PV(PI), rho_c);
    r = r * PV(N0_RAI);
    r = r * n0_sno;
    r = r * PV(M0_SNO);
    r = r * PV(CHIM_SNO);
    r = r * PV(E_RS);
    r = r * dv_rs;
    r = r * PV(GC_SNO);
    r = r * PV(INV_R0D_SNO);
    r = r * snow_rain_bracket(lam_rai, lam_sno, PV(EXP1_SNO), PV(EXP2_SNO),
                              PV(EXP3_SNO), PV(C2_SNO), PV(C3_SNO));
    const real S_sno_rai = both ? r : real(0);
    t.accr_rai_sno_cold = is_warm ? real(0) : S_rai_sno;
    t.accr_rai_sno_warm = is_warm ? S_sno_rai : real(0);
    t.accr_melt_rai_sno = is_warm ? alpha_melt * S_rai_sno : real(0);
  }

  // ---- evaporation, sublimation/deposition, melt -----------------------
  t.vap_rai = real(0);
  if (kRainEvaporation) {  // conv_q_rai_to_q_vap
    const real S = p_v / p_sat_l - real(1);
    const real G = real(1) / (Lv * PV(INV_K_THERM_SAFE) / T *
                                  (Lv * PV(INV_R_V) / T - real(1)) +
                              T * PV(R_V) * PV(INV_D_VAPOR_SAFE) / maxf(p_sat_l, eps));
    const real vent = PV(VA_RAI) +
                      PV(VBSC_RAI) * exp_(PV(PVENT_RAI) * (log_lam_rai - PV(LOG_R0_RAI))) *
                          sqrt_(real(2) * v0_rai * PV(CHIV_RAI) * PV(INV_NU_AIR) * lam_rai) *
                          PV(GVENT_RAI);
    const real evap =
        rdiv(PV(C4PI_N0_RAI), rho_c) * S * G * (lam_rai * lam_rai) * vent;
    const real rate = (qr_c > eps && S < real(0)) ? evap : real(0);
    t.vap_rai = minf(rate, real(0));
  }

  const real vent_sno = PV(VA_SNO) +
                        PV(VBSC_SNO) * exp_(PV(PVENT_SNO) * (log_lam_sno - PV(LOG_R0_SNO))) *
                            sqrt_(PV(SQ_SNO) * lam_sno) * PV(GVENT_SNO);
  t.vap_sno = real(0);
  if (kSnowDepSubl) {  // conv_q_sno_to_q_vap
    const real subl =
        PV(PI4) * n0_sno / rho_c * S_ice * G_ice * (lam_sno * lam_sno) * vent_sno;
    const real rate = qs_c > eps ? subl : real(0);
    // SublimationOnly: no deposition
    t.vap_sno = kSnowDepSubl == 2 ? minf(rate, real(0)) : rate;
  }

  const real dT_f = T - PV(T_FREEZE);
  const bool above_freezing = T > PV(T_FREEZE);
  t.melt_icl_lcl = real(0);
  if (kCloudIceMelt) {  // conv_q_icl_to_q_lcl
    const real rate = rdiv(PV(C4PI_N0_ICL), rho_c) * PV(K_THERM) / Lf * dT_f *
                      (lam_icl * lam_icl);
    t.melt_icl_lcl = (qi_c > eps && above_freezing) ? rate : real(0);
  }
  t.melt_sno_rai = real(0);
  if (kSnowMelt) {  // conv_q_sno_to_q_rai
    const real rate = PV(PI4) * n0_sno / rho_c * PV(K_THERM) / Lf * dT_f *
                      (lam_sno * lam_sno) * vent_sno;
    t.melt_sno_rai = (qs_c > eps && above_freezing) ? rate : real(0);
  }
  return t;
}

struct Tendencies {
  real dq_lcl, dq_icl, dq_rai, dq_sno;
};

// aggregate_tendencies_1m (models/tendencies.py)
__device__ __forceinline__ Tendencies aggregate(const Terms& t) {
  Tendencies d;
  d.dq_lcl = t.vap_lcl - t.acnv_lcl_rai - t.accr_lcl_rai - t.accr_lcl_sno_cold -
             t.accr_lcl_sno_warm + t.melt_icl_lcl;
  d.dq_icl = t.vap_icl - t.acnv_icl_sno - t.accr_icl_rai - t.accr_icl_sno -
             t.melt_icl_lcl;
  d.dq_rai = t.acnv_lcl_rai + t.accr_lcl_rai + t.accr_lcl_sno_warm +
             t.accr_melt_lcl_sno - t.accr_freeze_icl_rai - t.accr_rai_sno_cold +
             t.accr_rai_sno_warm + t.accr_melt_rai_sno + t.vap_rai + t.melt_sno_rai;
  d.dq_sno = t.acnv_icl_sno + t.accr_lcl_sno_cold - t.accr_melt_lcl_sno +
             t.accr_icl_rai + t.accr_freeze_icl_rai + t.accr_icl_sno +
             t.accr_rai_sno_cold - t.accr_rai_sno_warm - t.accr_melt_rai_sno +
             t.vap_sno - t.melt_sno_rai;
  return d;
}

// One linearized implicit substep (models/tendencies.py:
// _linearized_implicit_step) from the source terms `t` of the substep's
// state (rho, T, q_tot, q_lcl ... q_sno, unclamped): the donor-based
// linearization (_linearize), the cap on the vapor sources, the 2x2 cloud
// block and the reduced 2x2 precipitation block. Returns the substep's
// rates.
__device__ __forceinline__ Tendencies implicit_substep(const Terms& t, real rho,
                                                       real T, real q_tot,
                                                       real q_lcl, real q_icl,
                                                       real q_rai, real q_sno,
                                                       real inv_dt) {
  const real q_min = PV(Q_MIN);
  // donor(S, q) = S / torch.clamp(q, min=q_min)
  auto donor = [q_min](real S, real q) { return S / maxf(q, q_min); };
  real M11 = 0, M12 = 0, M22 = 0, M31 = 0, M33 = 0, M34 = 0;
  real M41 = 0, M42 = 0, M43 = 0, M44 = 0, e1 = 0, e2 = 0, e4 = 0;
  real D;
  bool src;

  // vapor <-> cloud condensate: source -> constant e; sink -> linear
  D = donor(t.vap_lcl, q_lcl);
  src = t.vap_lcl >= real(0);
  e1 = e1 + (src ? t.vap_lcl : real(0));
  M11 = M11 + (src ? real(0) : D);
  D = donor(t.vap_icl, q_icl);
  src = t.vap_icl >= real(0);
  e2 = e2 + (src ? t.vap_icl : real(0));
  M22 = M22 + (src ? real(0) : D);
  // ice cloud melt -> liquid cloud
  D = donor(t.melt_icl_lcl, q_icl);
  M22 = M22 - D;
  M12 = M12 + D;
  // autoconversion
  D = donor(t.acnv_lcl_rai, q_lcl);
  M11 = M11 - D;
  M31 = M31 + D;
  D = donor(t.acnv_icl_sno, q_icl);
  M22 = M22 - D;
  M42 = M42 + D;
  // accretion
  D = donor(t.accr_lcl_rai, q_lcl);
  M11 = M11 - D;
  M31 = M31 + D;
  const real D_cold = donor(t.accr_lcl_sno_cold, q_lcl);
  const real D_warm = donor(t.accr_lcl_sno_warm, q_lcl);
  M11 = M11 - (D_cold + D_warm);
  M31 = M31 + D_warm;
  M41 = M41 + D_cold;
  D = donor(t.accr_melt_lcl_sno, q_sno);
  M44 = M44 - D;
  M34 = M34 + D;
  D = donor(t.accr_icl_rai, q_icl);
  M22 = M22 - D;
  M42 = M42 + D;
  D = donor(t.accr_icl_sno, q_icl);
  M22 = M22 - D;
  M42 = M42 + D;
  D = donor(t.accr_freeze_icl_rai, q_rai);
  M33 = M33 - D;
  M43 = M43 + D;
  D = donor(t.accr_rai_sno_warm, q_sno);
  M44 = M44 - D;
  M34 = M34 + D;
  D = donor(t.accr_melt_rai_sno, q_sno);
  M44 = M44 - D;
  M34 = M34 + D;
  D = donor(t.accr_rai_sno_cold, q_rai);
  M33 = M33 - D;
  M43 = M43 + D;
  // rain evaporation: sink (<= 0) -> linear
  D = donor(-t.vap_rai, q_rai);
  M33 = M33 - D;
  // snow dep/subl: source -> e; sink -> linear
  D = donor(t.vap_sno, q_sno);
  src = t.vap_sno >= real(0);
  e4 = e4 + (src ? t.vap_sno : real(0));
  M44 = M44 + (src ? real(0) : D);
  // snow melt -> rain
  D = donor(t.melt_sno_rai, q_sno);
  M44 = M44 - D;
  M34 = M34 + D;

  // cap the vapor -> condensate sources jointly so that the substep cannot
  // drive q_v below min(q_sat_liq, q_sat_ice)
  const real q_sat_min =
      tmin(t.p_sat_l / (rho * PV(R_V) * T), t.p_sat_i / (rho * PV(R_V) * T));
  const real q_v = q_tot - q_lcl - q_icl - q_rai - q_sno;
  const real e_sum = e1 + e2 + e4;
  const real alpha = minf(maxf(q_v - q_sat_min, real(0)) * inv_dt /
                              maxf(e_sum, PV(EPS_MACH)),
                          real(1));

  const real a11 = inv_dt - M11;
  const real a12 = -M12;
  const real a22 = inv_dt - M22;
  const real a31 = -M31;
  const real a33 = inv_dt - M33;
  const real a34 = -M34;
  const real a41 = -M41;
  const real a42 = -M42;
  const real a43 = -M43;
  const real a44 = inv_dt - M44;

  const real b1 = alpha * e1 + q_lcl * inv_dt;
  const real b2 = alpha * e2 + q_icl * inv_dt;
  const real b3 = q_rai * inv_dt;
  const real b4 = alpha * e4 + q_sno * inv_dt;

  // 2x2 cloud block (a21 = 0)
  const real det12 = a11 * a22;
  const real q_lcl_new = (b1 * a22 - a12 * b2) / det12;
  const real q_icl_new = a11 * b2 / det12;
  // reduced 2x2 precip block
  const real r3 = b3 - a31 * q_lcl_new;
  const real r4 = b4 - a41 * q_lcl_new - a42 * q_icl_new;
  const real det = a33 * a44 - a34 * a43;
  const real q_rai_new = (r3 * a44 - a34 * r4) / det;
  const real q_sno_new = (a33 * r4 - r3 * a43) / det;

  Tendencies d;
  d.dq_lcl = (q_lcl_new - q_lcl) * inv_dt;
  d.dq_icl = (q_icl_new - q_icl) * inv_dt;
  d.dq_rai = (q_rai_new - q_rai) * inv_dt;
  d.dq_sno = (q_sno_new - q_sno) * inv_dt;
  return d;
}

struct CellOut {
  real T_new, q_tot;                   // stepped T; q_tot before sedimentation
  real dq_lcl, dq_icl, dq_rai, dq_sno; // process-rate tendencies
  real F_lcl, F_icl, F_rai, F_sno;     // downward mass fluxes
};

// Everything of models/column.py:step_column_1m for one cell, except the
// flux exchange between levels. trn_r, trn_s: the autoconversions' logistic
// translations.
__device__ __forceinline__ CellOut cell_step(real trn_r, real trn_s, real rho,
                                             real T, real q_tot, real q_lcl,
                                             real q_icl, real q_rai, real q_sno,
                                             real dt, bool sediment_cloud,
                                             const Substeps& sub) {
  const real eps = PV(EPS);
  real w_rai, w_sno, Lv, Ls, cp_air;
  Tendencies d;
  if (!kLinearized) {
    const Terms t = source_terms(trn_r, trn_s, rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno);
    d = aggregate(t);
    w_rai = t.w_rai;
    w_sno = t.w_sno;
    Lv = t.Lv;
    Ls = t.Ls;
    cp_air = t.cp_air;
  } else {
    // bulk_tendencies_1m(mode="linearized_average"): nsub substeps of
    // dt / nsub from (T, q_lcl ... q_sno), rho and q_tot held; substep 0's
    // state is the cell's, so its terms also give the fall speeds, latent
    // heats and heat capacity of the column step (its shared size
    // distribution)
    real T_c = T + real(0);
    real ql = q_lcl, qi = q_icl, qr = q_rai, qs = q_sno;
    for (int s = 0; s < sub.nsub; ++s) {
      const Terms t = source_terms(trn_r, trn_s, rho, T_c, q_tot, ql, qi, qr, qs);
      if (s == 0) {
        w_rai = t.w_rai;
        w_sno = t.w_sno;
        Lv = t.Lv;
        Ls = t.Ls;
        cp_air = t.cp_air;
      }
      const Tendencies r = implicit_substep(t, rho, T_c, q_tot, ql, qi, qr, qs,
                                            sub.inv_dt_sub);
      ql = ql + r.dq_lcl * sub.dt_sub;
      qi = qi + r.dq_icl * sub.dt_sub;
      qr = qr + r.dq_rai * sub.dt_sub;
      qs = qs + r.dq_sno * sub.dt_sub;
      T_c = T_c + (PV(LV_OVER_CP) * (r.dq_lcl + r.dq_rai) +
                   PV(LS_OVER_CP) * (r.dq_icl + r.dq_sno)) *
                      sub.dt_sub;
    }
    d.dq_lcl = (ql - q_lcl) * sub.inv_dt;
    d.dq_icl = (qi - q_icl) * sub.inv_dt;
    d.dq_rai = (qr - q_rai) * sub.inv_dt;
    d.dq_sno = (qs - q_sno) * sub.inv_dt;
  }

  // ---- sedimentation velocities and fluxes (models/column.py) ----------
  CellOut o;
  o.F_rai = rho * w_rai * q_rai;
  o.F_sno = rho * w_sno * q_sno;
  if (sediment_cloud) {
    const real ql_s = maxf(q_lcl, real(0));
    const real qi_s = maxf(q_icl, real(0));
    // Stokes regime cloud liquid (ops/noneq.py:terminal_velocity)
    const real pref = PV(C18) * (rdiv(PV(RHO_W_STOKES), rho) - real(1)) *
                      PV(GRAV_STOKES) * PV(INV_NU_STOKES);
    const real log_x = log_(PV(C6PI) * rho * ql_s * PV(INV_N0_LCL) * PV(INV_RHO_W_LCL));
    const real w_lcl_raw = pref * exp_(PV(C23) * log_x);
    const real w_lcl = q_lcl > eps ? w_lcl_raw : real(0);
    // Chen 2022 small ice
    const real rho_a = maxf(rho, real(0));
    const real b = PV(BS) + rho_a * PV(CS);
    const real rho_pow = exp_(PV(AS) * log_(rho_a));
    const real unit = exp_(b * PV(LOG1000));
    const real a1 = PV(ES) * rho_pow * unit;
    const real a2 = PV(FS) * rho_pow * unit;
    real log_D =
        log_(PV(C6PI) * rho * qi_s * PV(INV_N0_ICL_SED) * PV(INV_RHO_I_ICL)) * kThird;
    log_D = maxf(log_D, PV(LOG_TINY));
    const real D = exp_(log_D);
    const real sum = a1 * exp_(b * log_D - D * real(0)) +
                     a2 * exp_(b * log_D - PV(GS1000) * D);
    const real w_icl = q_icl > eps ? maxf(sum, real(0)) : real(0);
    o.F_lcl = rho * w_lcl * q_lcl;
    o.F_icl = rho * w_icl * q_icl;
  } else {
    o.F_lcl = real(0);
    o.F_icl = real(0);
  }

  // ---- latent heating: T-dependent Lv, Ls and moist cp -----------------
  o.T_new = T + dt * (Lv * (d.dq_lcl + d.dq_rai) + Ls * (d.dq_icl + d.dq_sno)) / cp_air;
  o.q_tot = q_tot;
  o.dq_lcl = d.dq_lcl;
  o.dq_icl = d.dq_icl;
  o.dq_rai = d.dq_rai;
  o.dq_sno = d.dq_sno;
  return o;
}

// Copy this lane's cell of one warp chunk (level k of column col) of the
// seven fields into its slots of a shared buffer, asynchronously (cp.async,
// one group); levels above nlev are filled with zeros.
__device__ __forceinline__ void fetch_chunk(const Fields& f, int col, int k,
                                            int nlev, real (*buf)[32], int lane) {
  const bool active = k < nlev;
  const int64_t idx = (int64_t)col * nlev + (active ? k : 0);
#pragma unroll
  for (int i = 0; i < kFields; ++i) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[i][lane]);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(f.in[i] + idx), "n"((int)sizeof(real)),
                 "r"(active ? (int)sizeof(real) : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, kBuildMinBlocks)
column1m_step_kernel(const __grid_constant__ Fields f, int ncol, int nlev,
                     int block_cols, real dt, real dz,
                     int sediment_cloud, int has_affine, real scale, real bias,
                     Substeps sub) {
  // per warp, two chunks' fields: the one being stepped and the next
  __shared__ real stage[kWarps][2][kFields][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = (nlev + 31) >> 5;
  const int block_end = (blockIdx.x + 1) * block_cols;
  const int end = block_end < ncol ? block_end : ncol;
  const real trn_r = kRainAutoconversion == 1 ? logistic_translation(PV(ACNV_R_K)) : real(0);
  const real trn_s = kSnowAutoconversion == 1 ? logistic_translation(PV(ACNV_S_K)) : real(0);
  PROBE_START;

  // iteration (col, c): chunk c of column col, top chunk first
  int col = blockIdx.x * block_cols + warp;
  int c = nchunks - 1;
  int slot = 0;
  if (col < end) fetch_chunk(f, col, 32 * c + lane, nlev, stage[warp][0], lane);
  // lane 31: lane 0's fluxes of the chunk above; none above the top chunk
  real carry_lcl = 0, carry_icl = 0, carry_rai = 0, carry_sno = 0;
  while (col < end) {
    PROBE_PASS;
    const int k = 32 * c + lane;
    const bool active = k < nlev;
    const int next_col = c == 0 ? col + kWarps : col;
    const int next_c = c == 0 ? nchunks - 1 : c - 1;
    // the next chunk's copies are in flight while this one is stepped
    if (next_col < end)
      fetch_chunk(f, next_col, 32 * next_c + lane, nlev, stage[warp][slot ^ 1], lane);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    real q[kFields];
#pragma unroll
    for (int i = 0; i < kFields; ++i) q[i] = stage[warp][slot][i][lane];
    PROBE_SINK(q[0] + q[1] + q[2] + q[3] + q[4] + q[5] + q[6]);
    PROBE_STAGE(S_LOAD);

    const real rho = q[0];
    const real q_tot = has_affine ? q[2] * scale + bias : q[2];
    CellOut o = {};   // levels above nlev: zero flux
    if (active)
      o = cell_step(trn_r, trn_s, rho, q[1], q_tot, q[3], q[4], q[5], q[6], dt,
                    sediment_cloud != 0, sub);
    PROBE_SINK(o.F_lcl + o.F_icl + o.F_rai + o.F_sno + o.T_new + o.dq_lcl + o.dq_icl +
            o.dq_rai + o.dq_sno);
    PROBE_STAGE(S_CELL);

    // inflow from level k + 1: the next lane's flux, by a rotation that
    // hands lane 31 lane 0's, which lane 31 keeps for the chunk below and
    // takes from the chunk above
    const int from = (lane + 1) & 31;
    const bool bottom = c == 0;   // the next chunk starts a column's top
    real in_lcl = shfl(o.F_lcl, from);
    real in_icl = shfl(o.F_icl, from);
    real in_rai = shfl(o.F_rai, from);
    real in_sno = shfl(o.F_sno, from);
    if (lane == 31) {
      real t;
      t = in_lcl, in_lcl = carry_lcl, carry_lcl = bottom ? real(0) : t;
      t = in_icl, in_icl = carry_icl, carry_icl = bottom ? real(0) : t;
      t = in_rai, in_rai = carry_rai, carry_rai = bottom ? real(0) : t;
      t = in_sno, in_sno = carry_sno, carry_sno = bottom ? real(0) : t;
    }
    PROBE_SINK(in_lcl + in_icl + in_rai + in_sno + carry_lcl + carry_icl + carry_rai +
            carry_sno);
    PROBE_STAGE(S_EXCHANGE);

    if (active) {
      const int64_t idx = (int64_t)col * nlev + k;
      const real rho_dz = rho * dz;
      const real sed_lcl = (in_lcl - o.F_lcl) / rho_dz;
      const real sed_icl = (in_icl - o.F_icl) / rho_dz;
      const real sed_rai = (in_rai - o.F_rai) / rho_dz;
      const real sed_sno = (in_sno - o.F_sno) / rho_dz;
      f.out[0][idx] = rho;
      f.out[1][idx] = o.T_new;
      f.out[2][idx] = maxf(o.q_tot + dt * (sed_lcl + sed_icl + sed_rai + sed_sno), real(0));
      f.out[3][idx] = maxf(q[3] + dt * (o.dq_lcl + sed_lcl), real(0));
      f.out[4][idx] = maxf(q[4] + dt * (o.dq_icl + sed_icl), real(0));
      f.out[5][idx] = maxf(q[5] + dt * (o.dq_rai + sed_rai), real(0));
      f.out[6][idx] = maxf(q[6] + dt * (o.dq_sno + sed_sno), real(0));
    }
    PROBE_STAGE(S_STORE);

    col = next_col;
    c = next_c;
    slot ^= 1;
  }
  PROBE_END;
}

int launch(const Fields& f, int ncol, int nlev, int block_cols, real dt,
           real dz, int sediment_cloud, int has_affine, real scale,
           real bias, const Substeps& sub, int device, void* stream) {
  if (nlev < 1 || block_cols < 1 || ncol < 1 || sub.nsub < 1)
    return (int)cudaErrorInvalidValue;
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (ncol + block_cols - 1) / block_cols;
  column1m_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
      bias, sub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column1m_threads_per_block() { return kThreads; }

int column1m_num_params() { return N_PARAMS; }

// Bytes of the build's scalar type: 4 (float32) or 8 (float64).
int column1m_real_bytes() { return (int)sizeof(scalar); }

// The build's mode and options: K1_LINEARIZED, then the 13 option codes, as
// the digits of one number (mode first).
long long column1m_variant() {
  const int codes[14] = {K1_LINEARIZED, kCloudLiquidFormation, kCloudIceFormation,
                         kCloudIceMelt, kRainAutoconversion, kSnowAutoconversion,
                         kRainEvaporation, kSnowDepSubl, kSnowMelt, kAccrLcrRai,
                         kAccrLclSno, kAccrIclRai, kAccrIclSno, kAccrRaiSno};
  long long v = 0;
  for (int i = 0; i < 14; ++i) v = v * 10 + codes[i];
  return v;
}

// Blocks of the kernel resident on one SM, as the CUDA runtime computes them
// from its registers and shared memory.
int column1m_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, column1m_step_kernel, kThreads, 0);
  return (int)err;
}

// Registers and local memory bytes per thread of the kernel.
int column1m_kernel_attrs(int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, column1m_step_kernel);
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

// K2: seven (ncol, nlev) inputs and seven outputs, in ColumnState order.
// nsub, dt_sub, inv_dt_sub, inv_dt: the substeps of linearized_average
// (read by that build only).
int column1m_step_unpacked(const scalar* rho, const scalar* T, const scalar* q_tot,
                           const scalar* q_lcl, const scalar* q_icl,
                           const scalar* q_rai, const scalar* q_sno,
                           scalar* rho_out, scalar* T_out, scalar* q_tot_out,
                           scalar* q_lcl_out, scalar* q_icl_out,
                           scalar* q_rai_out, scalar* q_sno_out, int ncol, int nlev,
                           int block_cols, scalar dt, scalar dz,
                           int sediment_cloud, int has_affine, scalar scale,
                           scalar bias, int nsub, scalar dt_sub, scalar inv_dt_sub,
                           scalar inv_dt, int device, void* stream) {
  const scalar* in[kFields] = {rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno};
  scalar* out[kFields] = {rho_out, T_out, q_tot_out, q_lcl_out, q_icl_out,
                          q_rai_out, q_sno_out};
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = reinterpret_cast<const real*>(in[i]);
    f.out[i] = reinterpret_cast<real*>(out[i]);
  }
  const Substeps sub = {nsub, dt_sub, inv_dt_sub, inv_dt};
  return launch(f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
                bias, sub, device, stream);
}

// K1: one (7, ncol, nlev) input and output; field i starts at i * plane.
int column1m_step_packed(const scalar* in, scalar* out, long long plane, int ncol,
                         int nlev, int block_cols, scalar dt, scalar dz,
                         int sediment_cloud, int has_affine, scalar scale,
                         scalar bias, int nsub, scalar dt_sub, scalar inv_dt_sub,
                         scalar inv_dt, int device, void* stream) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = reinterpret_cast<const real*>(in + i * plane);
    f.out[i] = reinterpret_cast<real*>(out + i * plane);
  }
  const Substeps sub = {nsub, dt_sub, inv_dt_sub, inv_dt};
  return launch(f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
                bias, sub, device, stream);
}

#ifdef K1_PROBE
int column1m_probe_stages() { return S_COUNT; }

// The (S_COUNT + 1) unsigned 64-bit sums the next launches add to: the
// cycles of each stage, then the warp passes.
int column1m_probe_set(unsigned long long* sums, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stage_probe, &sums, sizeof(sums));
  return (int)err;
}
#endif

}  // extern "C"
