// Fused 1-moment column step: one explicit-Euler step of the 18 1M source
// terms, upwind sedimentation of cloud liquid, cloud ice, rain and snow,
// and the latent-heat temperature update, over (ncol, nlev) f32 columns.
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
// to float (the INV_* parameters; 1/3 is kThird), `c / x` is
// reciprocal(x) * c, and a division by a tensor stays an IEEE division. The
// logistic integral of the autoconversions divides by x0 and k, which the
// eager step holds as device tensors: those two stay IEEE divisions too.
// Built with --fmad=false and without fast math. Each cell evaluates about
// 40 exp/log/pow/sqrt calls and 15 IEEE divisions; every intermediate stays
// in registers (one HBM read and one write per field).
//
// Parameters: the generated header defines each of the 136 floats of the
// parameter list as a float literal of its exact value (PC_<name>), and the
// library is built once per parameter block. Every constant is then an
// immediate operand: no global load, no constant-bank load, no register to
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
#include <float.h>
#include <stdint.h>

#include "column1m_params.h"

#ifdef K1_PROBE
#define STAGE_PROBE
#endif
#include "stage_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// resident blocks per SM the registers are held to: the fastest setting
// without spills of k1_occupancy_sweep.py (PERF.md)
constexpr int kMinBlocks = 2;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno
constexpr unsigned kFull = 0xffffffffu;
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kNegLog2 = (float)-0.6931471805599453;

struct Fields {
  const float* in[kFields];
  float* out[kFields];
};

#define PV(name) (PC_##name)

// max/min that return `a` when it is NaN, as torch.clamp does
__device__ __forceinline__ float maxf(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float minf(float a, float b) { return b < a ? b : a; }

// `c / x` for a Python scalar c and a tensor x is reciprocal(x) * c in torch
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

// torch.pow(x, p) for a scalar p: the small integer exponents are products
__device__ __forceinline__ float tpow(float x, float p) {
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// trnslt = -log1mexp(-k) / k of ops/common.py:logistic_function_integral, as
// the eager step evaluates it in float32 on the device
__device__ __forceinline__ float logistic_translation(float k) {
  const float x = -k;
  const float x_hi = minf(x, -FLT_MIN);
  const float l = x > kNegLog2 ? logf(-expm1f(x_hi)) : log1pf(-expf(x_hi));
  return -l / k;
}

// logistic_function_integral(x, x0, k) (ops/common.py) with x0_safe and k
// from the host and the translation from logistic_translation
__device__ __forceinline__ float logistic_integral(float x_in, float x0s, float k,
                                                   float trn, float x0_lt_eps,
                                                   float eps) {
  const float x = maxf(x_in, 0.0f);
  const float x_safe = maxf(x, eps);
  const float kt = k * (x_safe / x0s - 1.0f + trn);
  // logaddexp(0, kt)
  const float lae = maxf(0.0f, kt) + log1pf(expf(-fabsf(0.0f - kt)));
  float result = (lae / k - trn) * x0s;
  result = x < eps ? 0.0f : result;
  return x0_lt_eps != 0.0f ? x : result;
}

// _relaxation_tendency (ops/noneq.py) with one timescale: the eager step
// divides both arms and selects one; dividing only the selected numerator
// gives the same bits
__device__ __forceinline__ float relaxation(float sat_excess, float q_cond,
                                            float ts) {
  const float evap = -minf(-sat_excess, maxf(q_cond, 0.0f));
  return (sat_excess < 0.0f ? evap : sat_excess) / ts;
}

// _accretion_kernel (ops/m1.py), the same left-to-right product
__device__ __forceinline__ float accretion(float q_clo, float q_pre, float E,
                                           float n0, float a0, float v0,
                                           float chia, float chiv, float lam,
                                           float g, float pw, float eps) {
  float r = q_clo * E;
  r = r * n0;
  r = r * a0;
  r = r * v0;
  r = r * chia;
  r = r * chiv;
  r = r * lam;
  r = r * g;
  r = r * pw;
  return (q_clo > eps && q_pre > eps) ? r : 0.0f;
}

// the bracket of _accretion_snow_rain_kernel for collector i, species j
__device__ __forceinline__ float snow_rain_bracket(float lam_i, float lam_j,
                                                   float e1, float e2, float e3,
                                                   float c2, float c3) {
  const float t1 = (2.0f * (lam_i * lam_i * lam_i)) * tpow(lam_j, e1);
  const float t2 = (c2 * (lam_i * lam_i)) * tpow(lam_j, e2);
  const float t3 = (c3 * lam_i) * tpow(lam_j, e3);
  return t1 + t2 + t3;
}

struct CellOut {
  float T_new, q_tot;                   // stepped T; q_tot before sedimentation
  float dq_lcl, dq_icl, dq_rai, dq_sno; // process-rate tendencies
  float F_lcl, F_icl, F_rai, F_sno;     // downward mass fluxes
};

// Everything of models/column.py:step_column_1m for one cell, except the
// flux exchange between levels. trn_r, trn_s: the autoconversions' logistic
// translations.
__device__ __forceinline__ CellOut cell_step(float trn_r,
                                             float trn_s, float rho, float T,
                                             float q_tot, float q_lcl,
                                             float q_icl, float q_rai,
                                             float q_sno, float dt,
                                             bool sediment_cloud) {
  const float eps = PV(EPS);
  const float tiny = PV(TINY);
  const float log_eps = PV(LOG_EPS);

  // clamped state (micro/thermo of step_column_1m and the source terms)
  const float rho_c = maxf(rho, 0.0f);
  const float qt_c = maxf(q_tot, 0.0f);
  const float ql_c = maxf(q_lcl, 0.0f);
  const float qi_c = maxf(q_icl, 0.0f);
  const float qr_c = maxf(q_rai, 0.0f);
  const float qs_c = maxf(q_sno, 0.0f);

  // ---- size_distr_parameters (ops/m1.py), in shared log space ----------
  // (the eager step clamps the clamped fields to 0 once more: maxf(x_c, 0)
  // is x_c bit for bit, NaN and -0 included)
  const float log_rho = logf(maxf(rho_c, tiny));
  const float log_qr = logf(maxf(qr_c, tiny));
  const float log_qs = logf(maxf(qs_c, tiny));
  const float log_qi = logf(maxf(qi_c, tiny));

  const float log_n0s_raw =
      PV(LOG_MU_SNO) + PV(NU_SNO) * (log_rho + maxf(log_qs, log_eps));
  const bool sno_present = qs_c > eps;
  const float n0_sno = sno_present ? expf(log_n0s_raw) : 0.0f;
  const float log_n0_sno = sno_present ? maxf(log_n0s_raw, log_eps) : log_eps;

  float log_lam_rai =
      PV(POW_RAI) * (log_qr + log_rho + PV(LOGNUM_RAI) - PV(LOGDEN_RAI));
  log_lam_rai = qr_c > tiny ? log_lam_rai : PV(HALF_MIN);
  log_lam_rai = maxf(log_lam_rai, PV(LOGFLOOR_RAI));
  float log_lam_sno = PV(POW_SNO) *
                      (log_qs + log_rho + PV(LOGNUM_SNO) - (PV(LOGC_SNO) + log_n0_sno));
  log_lam_sno = qs_c > tiny ? log_lam_sno : PV(HALF_MIN);
  log_lam_sno = maxf(log_lam_sno, PV(LOGFLOOR_SNO));
  float log_lam_icl =
      PV(POW_ICL) * (log_qi + log_rho + PV(LOGNUM_ICL) - PV(LOGDEN_ICL));
  log_lam_icl = qi_c > tiny ? log_lam_icl : PV(HALF_MIN);
  log_lam_icl = maxf(log_lam_icl, PV(LOGFLOOR_ICL));

  const float lam_rai = expf(log_lam_rai);
  const float lam_sno = expf(log_lam_sno);
  const float lam_icl = expf(log_lam_icl);

  const float dens = maxf(rdiv(PV(RHO_W_VEL_RAI), rho_c) - 1.0f, 0.0f);
  const float v0_rai = sqrtf(PV(V0C_RAI) * dens * PV(GRAV_VEL_RAI) * PV(R0_VEL_RAI));

  // ---- thermodynamics shared by the rates (ops/thermo.py) --------------
  const float dT0 = T - PV(T_0);
  const float Lv = PV(LH_V0) + PV(DCP_VL) * dT0;
  const float Ls = PV(LH_S0) + PV(DCP_VI) * dT0;
  const float Lf = PV(LH_F0) + PV(DCP_LI) * dT0;
  const float q_liq = ql_c + qr_c;
  const float q_ice = qi_c + qs_c;
  const float cp_air = PV(CP_D) + PV(CPVD) * qt_c + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
  const float qv = maxf(qt_c - q_liq - q_ice, 0.0f);
  const float log_T = logf(T * PV(INV_T_TRIPLE));
  const float inv_T = 1.0f / T;
  const float dinv_T = PV(INV_T_TRIPLE) - inv_T;
  const float p_sat_l = PV(PRESS_TRIPLE) * expf(PV(KV_L) * log_T + PV(CL_L) * dinv_T);
  const float p_sat_i = PV(PRESS_TRIPLE) * expf(PV(KV_I) * log_T + PV(CL_I) * dinv_T);
  const float rho_Rv_T = rho_c * PV(R_V) * T;
  const float qv_sat_l = p_sat_l / rho_Rv_T;
  const float qv_sat_i = p_sat_i / rho_Rv_T;
  const float Rv_T2 = (T * T) * PV(R_V);
  const bool is_warm = T >= PV(T_FREEZE);

  // ---- cloud condensate formation (ops/noneq.py) -----------------------
  const float dqdT_l = qv_sat_l * (Lv / Rv_T2 - inv_T);
  const float ts_l = PV(TAU_LCL) * (1.0f + (Lv / cp_air) * dqdT_l);
  const float S_vap_lcl = relaxation(qv - qv_sat_l, ql_c, ts_l);

  const float dqdT_i = qv_sat_i * (Ls / Rv_T2 - inv_T);
  const float ts_i = PV(TAU_ICL) * (1.0f + (Ls / cp_air) * dqdT_i);
  float S_vap_icl = relaxation(qv - qv_sat_i, qi_c, ts_i);
  S_vap_icl = (T > PV(T_FREEZE) && S_vap_icl > 0.0f) ? 0.0f : S_vap_icl;

  // ---- autoconversion --------------------------------------------------
  const float S_acnv_lcl_rai =
      logistic_integral(ql_c, PV(ACNV_R_X0S), PV(ACNV_R_K), trn_r,
                        PV(ACNV_R_X0LT), eps) * PV(INV_ACNV_R_TAU);
  const float S_acnv_icl_sno =
      logistic_integral(qi_c, PV(ACNV_S_X0S), PV(ACNV_S_K), trn_s,
                        PV(ACNV_S_X0LT), eps) * PV(INV_ACNV_S_TAU);

  // ---- accretion -------------------------------------------------------
  const float pw_accr_rai = expf(PV(PACC_RAI) * (log_lam_rai - PV(LOG_R0_RAI)));
  const float pw_accr_sno = expf(PV(PACC_SNO) * (log_lam_sno - PV(LOG_R0_SNO)));

  const float S_accr_lcl_rai =
      accretion(ql_c, qr_c, PV(E_LR), PV(N0_RAI), PV(A0_RAI), v0_rai,
                PV(CHIA_RAI), PV(CHIV_RAI), lam_rai, PV(GACC_RAI), pw_accr_rai, eps);
  const float S_accr_ls =
      accretion(ql_c, qs_c, PV(E_LS), n0_sno, PV(A0_SNO), PV(V0_SNO),
                PV(CHIA_SNO), PV(CHIV_SNO), lam_sno, PV(GACC_SNO), pw_accr_sno, eps);
  const float alpha_melt =
      T <= PV(T_FREEZE) ? 0.0f : rdiv(PV(CV_L), Lf) * (T - PV(T_FREEZE));
  const float S_accr_lcl_sno_cold = is_warm ? 0.0f : S_accr_ls;
  const float S_accr_lcl_sno_warm = is_warm ? S_accr_ls : 0.0f;
  const float S_accr_melt_lcl_sno = alpha_melt * S_accr_ls;

  const float S_accr_icl_rai =
      accretion(qi_c, qr_c, PV(E_IR), PV(N0_RAI), PV(A0_RAI), v0_rai,
                PV(CHIA_RAI), PV(CHIV_RAI), lam_rai, PV(GACC_RAI), pw_accr_rai, eps);
  const float S_accr_icl_sno =
      accretion(qi_c, qs_c, PV(E_IS), n0_sno, PV(A0_SNO), PV(V0_SNO),
                PV(CHIA_SNO), PV(CHIV_SNO), lam_sno, PV(GACC_SNO), pw_accr_sno, eps);

  float S_accr_freeze_icl_rai;
  {  // _accretion_rain_sink_kernel
    const float pw = expf(PV(PSINK_RAI) * (log_lam_rai - PV(LOG_R0_RAI)));
    float r = rdiv(PV(E_IR), rho_c);
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
    S_accr_freeze_icl_rai = (qi_c > eps && qr_c > eps) ? r : 0.0f;
  }

  // bulk terminal velocities of rain and snow (power law), shared by the
  // rain-snow collisions and the sedimentation
  const float w_rai_raw = v0_rai * PV(CHIV_RAI) *
                          expf(PV(PVT_RAI) * (log_lam_rai - PV(LOG_R0_RAI))) *
                          PV(GTERM_RAI) * PV(INV_GC_RAI);
  const float w_rai = qr_c > eps ? w_rai_raw : 0.0f;
  const float w_sno_raw = PV(CV0_SNO) *
                          expf(PV(PVT_SNO) * (log_lam_sno - PV(LOG_R0_SNO))) *
                          PV(GTERM_SNO) * PV(INV_GC_SNO);
  const float w_sno = qs_c > eps ? w_sno_raw : 0.0f;

  float S_rai_sno, S_sno_rai;
  {  // _accretion_snow_rain_kernel, both collision orders
    const bool both = qs_c > eps && qr_c > eps;
    const float cd = PV(CD_RS);
    const float d_sr = w_sno - w_rai;
    const float dv_sr = sqrtf(d_sr * d_sr + cd * (w_sno * w_sno + w_rai * w_rai));
    float r = rdiv(PV(PI), rho_c);
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
    S_rai_sno = both ? r : 0.0f;

    const float d_rs = w_rai - w_sno;
    const float dv_rs = sqrtf(d_rs * d_rs + cd * (w_rai * w_rai + w_sno * w_sno));
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
    S_sno_rai = both ? r : 0.0f;
  }
  const float S_accr_rai_sno_cold = is_warm ? 0.0f : S_rai_sno;
  const float S_accr_rai_sno_warm = is_warm ? S_sno_rai : 0.0f;
  const float S_accr_melt_rai_sno = is_warm ? alpha_melt * S_rai_sno : 0.0f;

  // ---- evaporation, sublimation/deposition, melt -----------------------
  const float p_v = qv * rho_c * PV(R_V) * T;

  float S_vap_rai;
  {  // conv_q_rai_to_q_vap
    const float S = p_v / p_sat_l - 1.0f;
    const float G = 1.0f / (Lv * PV(INV_K_THERM_SAFE) / T *
                                (Lv * PV(INV_R_V) / T - 1.0f) +
                            T * PV(R_V) * PV(INV_D_VAPOR_SAFE) / maxf(p_sat_l, eps));
    const float vent = PV(VA_RAI) +
                       PV(VBSC_RAI) * expf(PV(PVENT_RAI) * (log_lam_rai - PV(LOG_R0_RAI))) *
                           sqrtf(2.0f * v0_rai * PV(CHIV_RAI) * PV(INV_NU_AIR) * lam_rai) *
                           PV(GVENT_RAI);
    const float evap =
        rdiv(PV(C4PI_N0_RAI), rho_c) * S * G * (lam_rai * lam_rai) * vent;
    const float rate = (qr_c > eps && S < 0.0f) ? evap : 0.0f;
    S_vap_rai = minf(rate, 0.0f);
  }

  const float vent_sno = PV(VA_SNO) +
                         PV(VBSC_SNO) * expf(PV(PVENT_SNO) * (log_lam_sno - PV(LOG_R0_SNO))) *
                             sqrtf(PV(SQ_SNO) * lam_sno) * PV(GVENT_SNO);
  float S_vap_sno;
  {  // conv_q_sno_to_q_vap, DepositionAndSublimation
    const float S = p_v / p_sat_i - 1.0f;
    const float G = 1.0f / (Ls * PV(INV_K_THERM_SAFE) / T *
                                (Ls * PV(INV_R_V) / T - 1.0f) +
                            T * PV(R_V) * PV(INV_D_VAPOR_SAFE) / maxf(p_sat_i, eps));
    const float subl = PV(PI4) * n0_sno / rho_c * S * G * (lam_sno * lam_sno) * vent_sno;
    S_vap_sno = qs_c > eps ? subl : 0.0f;
  }

  const float dT_f = T - PV(T_FREEZE);
  const bool above_freezing = T > PV(T_FREEZE);
  float S_melt_icl_lcl;
  {  // conv_q_icl_to_q_lcl
    const float rate = rdiv(PV(C4PI_N0_ICL), rho_c) * PV(K_THERM) / Lf * dT_f *
                       (lam_icl * lam_icl);
    S_melt_icl_lcl = (qi_c > eps && above_freezing) ? rate : 0.0f;
  }
  float S_melt_sno_rai;
  {  // conv_q_sno_to_q_rai
    const float rate = PV(PI4) * n0_sno / rho_c * PV(K_THERM) / Lf * dT_f *
                       (lam_sno * lam_sno) * vent_sno;
    S_melt_sno_rai = (qs_c > eps && above_freezing) ? rate : 0.0f;
  }

  // ---- aggregate_tendencies_1m (models/tendencies.py) ------------------
  const float dq_lcl = S_vap_lcl - S_acnv_lcl_rai - S_accr_lcl_rai -
                       S_accr_lcl_sno_cold - S_accr_lcl_sno_warm + S_melt_icl_lcl;
  const float dq_icl = S_vap_icl - S_acnv_icl_sno - S_accr_icl_rai -
                       S_accr_icl_sno - S_melt_icl_lcl;
  const float dq_rai = S_acnv_lcl_rai + S_accr_lcl_rai + S_accr_lcl_sno_warm +
                       S_accr_melt_lcl_sno - S_accr_freeze_icl_rai -
                       S_accr_rai_sno_cold + S_accr_rai_sno_warm +
                       S_accr_melt_rai_sno + S_vap_rai + S_melt_sno_rai;
  const float dq_sno = S_acnv_icl_sno + S_accr_lcl_sno_cold - S_accr_melt_lcl_sno +
                       S_accr_icl_rai + S_accr_freeze_icl_rai + S_accr_icl_sno +
                       S_accr_rai_sno_cold - S_accr_rai_sno_warm -
                       S_accr_melt_rai_sno + S_vap_sno - S_melt_sno_rai;

  // ---- sedimentation velocities and fluxes (models/column.py) ----------
  CellOut o;
  o.F_rai = rho * w_rai * q_rai;
  o.F_sno = rho * w_sno * q_sno;
  if (sediment_cloud) {
    const float ql_s = maxf(q_lcl, 0.0f);
    const float qi_s = maxf(q_icl, 0.0f);
    // Stokes regime cloud liquid (ops/noneq.py:terminal_velocity)
    const float pref = PV(C18) * (rdiv(PV(RHO_W_STOKES), rho) - 1.0f) *
                       PV(GRAV_STOKES) * PV(INV_NU_STOKES);
    const float log_x = logf(PV(C6PI) * rho * ql_s * PV(INV_N0_LCL) * PV(INV_RHO_W_LCL));
    const float w_lcl_raw = pref * expf(PV(C23) * log_x);
    const float w_lcl = q_lcl > eps ? w_lcl_raw : 0.0f;
    // Chen 2022 small ice
    const float rho_a = maxf(rho, 0.0f);
    const float b = PV(BS) + rho_a * PV(CS);
    const float rho_pow = expf(PV(AS) * logf(rho_a));
    const float unit = expf(b * PV(LOG1000));
    const float a1 = PV(ES) * rho_pow * unit;
    const float a2 = PV(FS) * rho_pow * unit;
    float log_D =
        logf(PV(C6PI) * rho * qi_s * PV(INV_N0_ICL_SED) * PV(INV_RHO_I_ICL)) * kThird;
    log_D = maxf(log_D, PV(LOG_TINY));
    const float D = expf(log_D);
    const float sum = a1 * expf(b * log_D - D * 0.0f) +
                      a2 * expf(b * log_D - PV(GS1000) * D);
    const float w_icl = q_icl > eps ? maxf(sum, 0.0f) : 0.0f;
    o.F_lcl = rho * w_lcl * q_lcl;
    o.F_icl = rho * w_icl * q_icl;
  } else {
    o.F_lcl = 0.0f;
    o.F_icl = 0.0f;
  }

  // ---- latent heating: T-dependent Lv, Ls and moist cp -----------------
  o.T_new = T + dt * (Lv * (dq_lcl + dq_rai) + Ls * (dq_icl + dq_sno)) / cp_air;
  o.q_tot = q_tot;
  o.dq_lcl = dq_lcl;
  o.dq_icl = dq_icl;
  o.dq_rai = dq_rai;
  o.dq_sno = dq_sno;
  return o;
}

// Copy this lane's cell of one warp chunk (level k of column col) of the
// seven fields into its slots of a shared buffer, asynchronously (cp.async,
// one group); levels above nlev are filled with zeros.
__device__ __forceinline__ void fetch_chunk(const Fields& f, int col, int k,
                                            int nlev, float (*buf)[32], int lane) {
  const bool active = k < nlev;
  const int64_t idx = (int64_t)col * nlev + (active ? k : 0);
#pragma unroll
  for (int i = 0; i < kFields; ++i) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[i][lane]);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(f.in[i] + idx), "r"(active ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
column1m_step_kernel(const __grid_constant__ Fields f, int ncol, int nlev,
                     int block_cols, float dt, float dz,
                     int sediment_cloud, int has_affine, float scale, float bias) {
  // per warp, two chunks' fields: the one being stepped and the next
  __shared__ float stage[kWarps][2][kFields][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = (nlev + 31) >> 5;
  const int block_end = (blockIdx.x + 1) * block_cols;
  const int end = block_end < ncol ? block_end : ncol;
  const float trn_r = logistic_translation(PV(ACNV_R_K));
  const float trn_s = logistic_translation(PV(ACNV_S_K));
  PROBE_START;

  // iteration (col, c): chunk c of column col, top chunk first
  int col = blockIdx.x * block_cols + warp;
  int c = nchunks - 1;
  int slot = 0;
  if (col < end) fetch_chunk(f, col, 32 * c + lane, nlev, stage[warp][0], lane);
  // lane 31: lane 0's fluxes of the chunk above; none above the top chunk
  float carry_lcl = 0.0f, carry_icl = 0.0f, carry_rai = 0.0f, carry_sno = 0.0f;
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
    float q[kFields];
#pragma unroll
    for (int i = 0; i < kFields; ++i) q[i] = stage[warp][slot][i][lane];
    PROBE_SINK(q[0] + q[1] + q[2] + q[3] + q[4] + q[5] + q[6]);
    PROBE_STAGE(S_LOAD);

    const float rho = q[0];
    const float q_tot = has_affine ? q[2] * scale + bias : q[2];
    CellOut o = {};   // levels above nlev: zero flux
    if (active)
      o = cell_step(trn_r, trn_s, rho, q[1], q_tot, q[3], q[4], q[5], q[6], dt,
                    sediment_cloud != 0);
    PROBE_SINK(o.F_lcl + o.F_icl + o.F_rai + o.F_sno + o.T_new + o.dq_lcl + o.dq_icl +
            o.dq_rai + o.dq_sno);
    PROBE_STAGE(S_CELL);

    // inflow from level k + 1: the next lane's flux, by a rotation that
    // hands lane 31 lane 0's, which lane 31 keeps for the chunk below and
    // takes from the chunk above
    const int from = (lane + 1) & 31;
    const bool bottom = c == 0;   // the next chunk starts a column's top
    float in_lcl = __shfl_sync(kFull, o.F_lcl, from);
    float in_icl = __shfl_sync(kFull, o.F_icl, from);
    float in_rai = __shfl_sync(kFull, o.F_rai, from);
    float in_sno = __shfl_sync(kFull, o.F_sno, from);
    if (lane == 31) {
      float t;
      t = in_lcl, in_lcl = carry_lcl, carry_lcl = bottom ? 0.0f : t;
      t = in_icl, in_icl = carry_icl, carry_icl = bottom ? 0.0f : t;
      t = in_rai, in_rai = carry_rai, carry_rai = bottom ? 0.0f : t;
      t = in_sno, in_sno = carry_sno, carry_sno = bottom ? 0.0f : t;
    }
    PROBE_SINK(in_lcl + in_icl + in_rai + in_sno + carry_lcl + carry_icl + carry_rai +
            carry_sno);
    PROBE_STAGE(S_EXCHANGE);

    if (active) {
      const int64_t idx = (int64_t)col * nlev + k;
      const float rho_dz = rho * dz;
      const float sed_lcl = (in_lcl - o.F_lcl) / rho_dz;
      const float sed_icl = (in_icl - o.F_icl) / rho_dz;
      const float sed_rai = (in_rai - o.F_rai) / rho_dz;
      const float sed_sno = (in_sno - o.F_sno) / rho_dz;
      f.out[0][idx] = rho;
      f.out[1][idx] = o.T_new;
      f.out[2][idx] = maxf(o.q_tot + dt * (sed_lcl + sed_icl + sed_rai + sed_sno), 0.0f);
      f.out[3][idx] = maxf(q[3] + dt * (o.dq_lcl + sed_lcl), 0.0f);
      f.out[4][idx] = maxf(q[4] + dt * (o.dq_icl + sed_icl), 0.0f);
      f.out[5][idx] = maxf(q[5] + dt * (o.dq_rai + sed_rai), 0.0f);
      f.out[6][idx] = maxf(q[6] + dt * (o.dq_sno + sed_sno), 0.0f);
    }
    PROBE_STAGE(S_STORE);

    col = next_col;
    c = next_c;
    slot ^= 1;
  }
  PROBE_END;
}

int launch(const Fields& f, int ncol, int nlev, int block_cols, float dt,
           float dz, int sediment_cloud, int has_affine, float scale,
           float bias, int device, void* stream) {
  if (nlev < 1 || block_cols < 1 || ncol < 1) return (int)cudaErrorInvalidValue;
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (ncol + block_cols - 1) / block_cols;
  column1m_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
      bias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column1m_threads_per_block() { return kThreads; }

int column1m_num_params() { return N_PARAMS; }

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
int column1m_step_unpacked(const float* rho, const float* T, const float* q_tot,
                           const float* q_lcl, const float* q_icl,
                           const float* q_rai, const float* q_sno,
                           float* rho_out, float* T_out, float* q_tot_out,
                           float* q_lcl_out, float* q_icl_out,
                           float* q_rai_out, float* q_sno_out, int ncol, int nlev,
                           int block_cols, float dt, float dz,
                           int sediment_cloud, int has_affine, float scale,
                           float bias, int device, void* stream) {
  Fields f = {{rho, T, q_tot, q_lcl, q_icl, q_rai, q_sno},
              {rho_out, T_out, q_tot_out, q_lcl_out, q_icl_out, q_rai_out,
               q_sno_out}};
  return launch(f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
                bias, device, stream);
}

// K1: one (7, ncol, nlev) input and output; field i starts at i * plane.
int column1m_step_packed(const float* in, float* out, long long plane, int ncol, int nlev,
                         int block_cols, float dt, float dz,
                         int sediment_cloud, int has_affine, float scale,
                         float bias, int device, void* stream) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = in + i * plane;
    f.out[i] = out + i * plane;
  }
  return launch(f, ncol, nlev, block_cols, dt, dz, sediment_cloud, has_affine, scale,
                bias, device, stream);
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
