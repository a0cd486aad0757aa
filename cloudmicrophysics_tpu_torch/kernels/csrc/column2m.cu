// Fused 2-moment warm-rain column step (Seifert-Beheng 2006): one explicit
// Euler step of the warm-rain process rates, number- and mass-weighted rain
// sedimentation and the latent-heat temperature update, over (ncol, nlev)
// f32 columns of (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai).
//
// Replaces the two Pallas TPU kernels of cloudmicrophysics_tpu/kernels/
// column2m.py: step_column_2m_pallas_packed (one (7, ncol, nlev) buffer in
// and out, optional q_tot affine on load) and step_column_2m_pallas (seven
// (ncol, nlev) buffers in and out). One __global__ body serves both; the
// two C entry points differ only in how they fill the field pointers.
//
// What bounds it on an H100: each cell reads 7 floats and writes 7 (56 B
// of HBM traffic) and evaluates some 25 exp/log/pow/sqrt calls, an lgamma
// per Chen 2022 term, and about 20 IEEE divisions, so, like the 1M step,
// it is expected to be bound by its instruction stream rather than by HBM.
// The design keeps every intermediate in registers (one HBM read and one
// write per field) and evaluates the rain PSD of the process rates once,
// shared by evaporation, self-collection and breakup. It is compiled
// without --use_fast_math and with --fmad=false, and each expression
// follows the eager PyTorch step's operation order as PyTorch's CUDA
// kernels evaluate it, so that it rounds like the plain version: `x / c`
// for a Python-float c is a multiply by c's reciprocal, taken in double
// and rounded once to float (the INV_* parameters, folded on the host),
// `c / x` is reciprocal(x) * c, and pow with exponent 2 or 3 is products.
//
// The options are compile-time variants: LIMITED (the SB2006 Eq 94-97 rain
// PSD limiters) and CHEN (Chen 2022 rain fall speeds instead of SB2006's
// Rogers-type fit), picked at launch.
//
// Layout: a thread owns one (column, level) cell. A block of kThreads
// threads covers `block_cols` whole columns in passes of kThreads / nlev
// columns, the level index fastest, so the loads and stores of a warp hit
// consecutive addresses of the nlev-contiguous fields. Sedimentation needs
// the two rain fluxes of the level above (k + 1): each thread writes its
// fluxes to shared memory, the block synchronises, and each thread reads
// its neighbour's. The top level gets no inflow.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column2m_params.h"

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kSixth = (float)(1.0 / 6.0);

struct Fields {
  const float* in[kFields];
  float* out[kFields];
};

#define PV(name) __ldg(P + P_##name)

// max/min that return `a` when it is NaN, as torch.clamp does
__device__ __forceinline__ float maxf(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float minf(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}

// `c / x` for a Python scalar c and a tensor x is reciprocal(x) * c in torch
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

// torch.pow(x, p) for a scalar p on CUDA: sqrt, reciprocal and products for
// the special exponents, powf otherwise
__device__ __forceinline__ float tpow(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 0.5f) return sqrtf(x);
  if (p == -1.0f) return 1.0f / x;
  if (p == -2.0f) return 1.0f / (x * x);
  return powf(x, p);
}

struct RainPDF {
  float Dr_mean, xr_mean;
};

// ops/m2.py:pdf_rain_parameters
template <bool LIMITED>
__device__ __forceinline__ RainPDF pdf_rain(const float* __restrict__ P,
                                            float q, float rho, float N) {
  const float em = PV(EM), en = PV(EN);
  const float safe_q = maxf(q, em);
  const float safe_N = maxf(N, en);
  const float L = rho * safe_q;
  float lam, xr;
  bool cond;
  if (LIMITED) {
    const float x_t = clampf(L / safe_N, PV(XR_MIN), PV(XR_MAX));
    const float N0 = clampf(safe_N * tpow(rdiv(PV(PI_RHO_W), x_t), kThird),
                            PV(N0_MIN), PV(N0_MAX));
    lam = clampf(sqrtf(sqrtf(PV(PI_RHO_W) * N0 / L)), PV(LAM_MIN), PV(LAM_MAX));
    xr = clampf(L * lam / N0, PV(XR_MIN), PV(XR_MAX));
    cond = N < en && q < em;
  } else {
    xr = L / safe_N;
    lam = tpow(rdiv(PV(PI_RHO_W), xr), kThird);
    cond = N < en || q < em;
  }
  RainPDF r;
  r.Dr_mean = cond ? 0.0f : 1.0f / lam;
  r.xr_mean = cond ? 0.0f : xr;
  return r;
}

// ops/m2.py:gamma_incl_approx with its four Python-float factors
__device__ __forceinline__ float gamma_incl(float x, float c0, float e0,
                                            float c1, float e1) {
  return expf(-x) / (c0 * tpow(x, e0) + c1 * tpow(x, e1));
}

// ops/m2.py:_sb_vel_helper's G4 moment factor
__device__ __forceinline__ float sb_g4(float t) {
  return (t * t * t + 3.0f * (t * t) + 6.0f * t + 6.0f) * expf(-t);
}

// ops/common.py:chen2022_exponential_pdf, moment k (delta = k + 1)
__device__ __forceinline__ float chen_term(float a, float b, float c,
                                           float lambda_inv, float delta,
                                           float inv_gamma_delta) {
  const float arg = -delta * logf(lambda_inv) -
                    (b + delta) * logf(1.0f / lambda_inv + c) +
                    lgammaf(b + delta);
  return a * expf(arg) * inv_gamma_delta;
}

struct CellOut {
  float T_new;
  float dq_lcl, dn_lcl, dq_rai, dn_rai;  // process-rate tendencies
  float F_q, F_n;                        // downward rain mass and number fluxes
};

// Everything of models/column.py:step_column_2m for one cell, except the
// flux exchange between levels.
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_step(const float* __restrict__ P,
                                             float rho, float T, float q_tot,
                                             float q_lcl, float n_lcl,
                                             float q_rai, float n_rai,
                                             float dt) {
  const float em = PV(EM), en = PV(EN);

  // ---- bulk_tendencies_2m: clamped state ------------------------------
  const float rho_c = maxf(rho, 0.0f);
  const float qt_c = maxf(q_tot, 0.0f);
  const float ql_c = maxf(q_lcl, 0.0f);
  const float qr_c = maxf(q_rai, 0.0f);
  const float nl_c = maxf(n_lcl, 0.0f);
  const float nr_c = maxf(n_rai, 0.0f);
  const float N_lcl = rho_c * nl_c;
  const float N_rai = rho_c * nr_c;

  // ---- thermodynamics (ops/thermo.py) ----------------------------------
  const float Lv = PV(LH_V0) + PV(DCP_VL) * (T - PV(T_0));
  const float q_liq = ql_c + qr_c;
  const float cp_air = PV(CP_D) + PV(CPVD) * qt_c + PV(CPLV) * q_liq;
  const float qv = maxf(qt_c - q_liq, 0.0f);
  const float inv_T = 1.0f / T;
  const float p_sat = PV(PRESS_TRIPLE) *
                      expf(PV(KV_L) * logf(T * PV(INV_T_TRIPLE)) +
                           PV(CL_L) * (PV(INV_T_TRIPLE) - inv_T));
  const float qv_sat = p_sat / (rho_c * PV(R_V) * T);

  // ---- condensation/evaporation, constant tau (ops/noneq.py) -----------
  float dq_cond;
  {
    const float dqdT = qv_sat * (Lv / (PV(R_V) * (T * T)) - inv_T);
    const float ts = PV(TAU_CE) * (1.0f + (Lv / cp_air) * dqdT);
    const float sat = qv - qv_sat;
    const float evap = -minf(-sat, maxf(ql_c, 0.0f)) / ts;
    const float dep = sat / ts;
    dq_cond = sat < 0.0f ? evap : dep;
  }

  // ---- rain PSD of the rates: evaporation, self-collection, breakup ----
  const float xr_mean = pdf_rain<LIMITED>(P, maxf(qr_c, em), rho_c, maxf(N_rai, en)).xr_mean;
  const float xr_safe = maxf(xr_mean, PV(TINY));
  const float Dr = tpow(6.0f * xr_safe * PV(INV_PI_RHO_W), kThird);

  // ---- rain evaporation (ops/m2.py:rain_evaporation) -------------------
  float dn_evap, dq_evap;
  {
    const float p_v = qv * rho_c * PV(R_V) * T;
    const float S = p_v / p_sat - 1.0f;
    const float p_vs = maxf(p_sat, PV(EPS_PSAT));
    const float G = 1.0f / (Lv * PV(INV_K_THERM) / T * (Lv * PV(INV_R_V) / T - 1.0f) +
                            PV(R_V) * T * PV(INV_D_VAPOR) / p_vs);
    const float t_star = tpow(rdiv(PV(SIX_X_STAR), xr_safe), kThird);
    const float a_vent_0 = PV(A_VENT_0) * gamma_incl(t_star, PV(GIA_C0_A), PV(GIA_E0_A),
                                                     PV(GIA_C1_A), PV(GIA_E1_A));
    const float b_vent_0 = PV(B_VENT_0) * gamma_incl(t_star, PV(GIA_C0_B), PV(GIA_E0_B),
                                                     PV(GIA_C1_B), PV(GIA_E1_B));
    const float N_Re = PV(ALPHA) * tpow(xr_safe, PV(BETA)) *
                       sqrtf(rdiv(PV(EVAP_RHO0), rho_c)) * Dr * PV(INV_NU_AIR);
    const float sqrt_N_Re = sqrtf(N_Re);
    const float Fv0 = a_vent_0 + b_vent_0 * PV(CBRT_SC) * sqrt_N_Re;
    const float Fv1 = PV(A_VENT_1) + PV(B_VENT_1_SC) * sqrt_N_Re;
    const float common = PV(TWO_PI) * G * S * N_rai * Dr;
    const float dn = minf(common * Fv0 / xr_safe, 0.0f);
    const float dq = minf(common * Fv1 / rho_c, 0.0f);
    const bool no_rain = qr_c < em || N_rai <= en || S >= 0.0f;
    dn_evap = (no_rain || xr_mean * PV(INV_XR_MIN) < PV(EPS_MACH)) ? 0.0f : dn;
    dq_evap = no_rain ? 0.0f : dq;
  }

  // ---- autoconversion + cloud self-collection --------------------------
  float au_dq_lcl, au_dN_lcl, au_dq_rai, au_dN_rai, sc_lcl;
  {
    const float sql = maxf(ql_c, em);
    const float sNl = maxf(N_lcl, en);
    const float L_lcl = rho_c * sql;
    const float x_lcl = minf(L_lcl / sNl, PV(X_STAR));
    const float sqr = maxf(qr_c, 0.0f);
    const float tau = 1.0f - sql / (sql + sqr);
    const float tau_safe = maxf(tau, em);
    const float ta = tpow(tau_safe, PV(ACNV_AEXP));
    const float phi_au =
        qr_c < em ? 0.0f : PV(ACNV_A) * ta * tpow(1.0f - ta, PV(ACNV_BEXP));
    const float omt = 1.0f - tau;
    const float dL = PV(ACNV_C) * (L_lcl * L_lcl) * (x_lcl * x_lcl) *
                     (1.0f + phi_au / (omt * omt)) * PV(ACNV_RHO0) / rho_c;
    const float dN_rai = dL * PV(INV_X_STAR);
    const bool cond = ql_c < em || N_lcl < en;
    au_dq_lcl = cond ? 0.0f : -dL / rho_c;
    au_dN_lcl = cond ? 0.0f : -2.0f * dN_rai;
    au_dq_rai = cond ? 0.0f : dL / rho_c;
    au_dN_rai = cond ? 0.0f : dN_rai;

    const float L2 = rho_c * ql_c;
    const float rate = PV(SC_LCL_C) * rdiv(PV(ACNV_RHO0), rho_c) * (L2 * L2) - au_dN_lcl;
    sc_lcl = ql_c < em ? 0.0f : rate;
  }

  // ---- accretion -------------------------------------------------------
  float ac_dq_lcl, ac_dN_lcl, ac_dq_rai;
  {
    const float sql = maxf(ql_c, em);
    const float sqr = maxf(qr_c, em);
    const float sNl = maxf(N_lcl, en);
    const float L_lcl = rho_c * sql;
    const float L_rai = rho_c * sqr;
    const float x_lcl = L_lcl / sNl;
    const float tau = 1.0f - sql / (sql + sqr);
    const float phi_ac = tpow(tau / (tau + PV(TAU0)), PV(ACCR_C));
    const float dL_rai =
        PV(KCR) * L_lcl * L_rai * phi_ac * sqrtf(rdiv(PV(ACCR_RHO0), rho_c));
    const float dL_lcl = -dL_rai;
    const bool cond = ql_c < em || qr_c < em || N_lcl < en;
    ac_dq_lcl = cond ? 0.0f : dL_lcl / rho_c;
    ac_dN_lcl = cond ? 0.0f : dL_lcl / x_lcl;
    ac_dq_rai = cond ? 0.0f : dL_rai / rho_c;
  }

  // ---- rain self-collection + breakup ----------------------------------
  float sc_rai, br_rai;
  {
    const float L_rai = rho_c * maxf(qr_c, em);
    const float Br = tpow(rdiv(6.0f, xr_mean), kThird);
    const float rate = PV(KRR_NEG) * N_rai * L_rai * sqrtf(rdiv(PV(PDF_RHO0), rho_c)) *
                       tpow(1.0f + rdiv(PV(KAPPA_RR), Br), PV(SC_D));
    const bool cond = qr_c < em || N_rai < en;
    sc_rai = cond ? 0.0f : rate;

    const float dD = Dr - PV(DEQ);
    const float phi_br = Dr < PV(DR_TH)
                             ? -1.0f
                             : (Dr <= PV(DEQ) ? PV(KBR) * dD : expf(PV(KAPPA_BR) * dD) - 1.0f);
    br_rai = cond ? 0.0f : -(phi_br + 1.0f) * sc_rai;
  }

  // ---- number adjustment from mass limits (Horn 2012) ------------------
  const float n_tgt_lcl =
      ql_c < em ? 0.0f
                : clampf(nl_c, ql_c * PV(INV_XC_MAX), ql_c * PV(INV_XC_MIN));
  const float numadj_lcl = (n_tgt_lcl - nl_c) * PV(INV_NUMADJ_TAU);
  const float n_tgt_rai =
      qr_c < em ? 0.0f
                : clampf(nr_c, qr_c * PV(INV_XR_MAX), qr_c * PV(INV_XR_MIN));
  const float numadj_rai = (n_tgt_rai - nr_c) * PV(INV_NUMADJ_TAU);

  // ---- warm_rain_tendencies_2m (models/tendencies.py) ------------------
  CellOut o;
  o.dq_lcl = dq_cond + au_dq_lcl + ac_dq_lcl;
  o.dq_rai = dq_evap + au_dq_rai + ac_dq_rai;
  o.dn_lcl = (au_dN_lcl + sc_lcl + ac_dN_lcl) / rho_c + numadj_lcl;
  o.dn_rai = (dn_evap + au_dN_rai + sc_rai + br_rai) / rho_c + numadj_rai;

  // ---- rain fall speeds (ops/m2.py:rain_terminal_velocity), unclamped --
  float vt_n, vt_m;
  {
    const float N_v = n_rai * rho;
    const float Dm = pdf_rain<LIMITED>(P, maxf(q_rai, em), rho, maxf(N_v, en)).Dr_mean;
    float v0, v1;
    if (CHEN) {
      const float rho_a = maxf(rho, 0.0f);
      const float shared = expf(PV(CH_RHO0) * rho_a - PV(CH_BRHO) * rho_a * PV(LOG1000));
      const float log_rho_a = logf(rho_a);
      const float a1 = PV(CH_A1U) * shared;
      const float a2 = PV(CH_A2U) * shared;
      const float a3 = PV(CH_A3U) * shared * expf(PV(CH_A3POW) * log_rho_a);
      const float b1 = PV(CH_B1) - PV(CH_BRHO) * rho_a;
      const float b2 = PV(CH_B2) - PV(CH_BRHO) * rho_a;
      const float b3 = PV(CH_B3) - PV(CH_BRHO) * rho_a;
      v0 = chen_term(a1, b1, PV(CH_C1U), Dm, 1.0f, 1.0f) +
           chen_term(a2, b2, PV(CH_C2U), Dm, 1.0f, 1.0f) +
           chen_term(a3, b3, PV(CH_C3U), Dm, 1.0f, 1.0f);
      v1 = chen_term(a1, b1, PV(CH_C1U), Dm, 4.0f, kSixth) +
           chen_term(a2, b2, PV(CH_C2U), Dm, 4.0f, kSixth) +
           chen_term(a3, b3, PV(CH_C3U), Dm, 4.0f, kSixth);
    } else {
      float pa0 = 1.0f, pb0 = 1.0f, pa1 = 1.0f, pb1 = 1.0f;
      if (!LIMITED) {
        const float lam_r = 1.0f / Dm;
        const float ta = PV(TWO_RC) * lam_r;
        const float tb = PV(TWO_RC) * (lam_r + PV(CR));
        pa0 = expf(-ta);
        pb0 = expf(-tb);
        pa1 = sb_g4(ta) * kSixth;
        pb1 = sb_g4(tb) * kSixth;
      }
      const float sq = sqrtf(rdiv(PV(VEL_RHO0), rho));
      const float den = 1.0f + PV(CR) * Dm;
      v0 = sq * (PV(AR) * pa0 - PV(BR) * pb0 / den);
      v1 = sq * (PV(AR) * pa1 - PV(BR) * pb1 / powf(den, 4.0f));
    }
    vt_n = N_v < en ? 0.0f : maxf(v0, 0.0f);
    vt_m = q_rai < em ? 0.0f : maxf(v1, 0.0f);
  }
  o.F_q = rho * vt_m * q_rai;
  o.F_n = rho * vt_n * n_rai;

  // ---- latent heating: T-dependent Lv and moist cp, unclamped state ----
  const float cp = PV(CP_D) + PV(CPVD) * q_tot + PV(CPLV) * (q_lcl + q_rai);
  o.T_new = T + dt * Lv / cp * (o.dq_lcl + o.dq_rai);
  return o;
}

template <bool LIMITED, bool CHEN>
__global__ void __launch_bounds__(kThreads)
column2m_step_kernel(Fields f, const float* __restrict__ P, int ncol, int nlev,
                     int block_cols, float dt, float dz, int has_affine,
                     float scale, float bias) {
  __shared__ float flux[2][kThreads];
  const int t = threadIdx.x;
  const int cols_per_pass = kThreads / nlev;
  const int lc = t / nlev;
  const int k = t - lc * nlev;
  const int64_t col_base = (int64_t)blockIdx.x * block_cols;

  for (int c0 = 0; c0 < block_cols; c0 += cols_per_pass) {
    const int64_t col = col_base + c0 + lc;
    const bool active = lc < cols_per_pass && c0 + lc < block_cols && col < ncol;
    const int64_t idx = col * nlev + k;
    float q[kFields];
    CellOut o;
    if (active) {
      #pragma unroll
      for (int i = 0; i < kFields; ++i) q[i] = f.in[i][idx];
      if (has_affine) q[2] = q[2] * scale + bias;
      o = cell_step<LIMITED, CHEN>(P, q[0], q[1], q[2], q[3], q[4], q[5], q[6], dt);
      flux[0][t] = o.F_q;
      flux[1][t] = o.F_n;
    }
    __syncthreads();
    if (active) {
      const bool top = k == nlev - 1;
      const float rho_dz = q[0] * dz;
      const float sed_q = ((top ? 0.0f : flux[0][t + 1]) - o.F_q) / rho_dz;
      const float sed_n = ((top ? 0.0f : flux[1][t + 1]) - o.F_n) / rho_dz;
      f.out[0][idx] = q[0];
      f.out[1][idx] = o.T_new;
      f.out[2][idx] = maxf(q[2] + dt * sed_q, 0.0f);
      f.out[3][idx] = maxf(q[3] + dt * o.dq_lcl, 0.0f);
      f.out[4][idx] = maxf(q[4] + dt * o.dn_lcl, 0.0f);
      f.out[5][idx] = maxf(q[5] + dt * (o.dq_rai + sed_q), 0.0f);
      f.out[6][idx] = maxf(q[6] + dt * (o.dn_rai + sed_n), 0.0f);
    }
    __syncthreads();
  }
}

int launch(const Fields& f, const float* params, int ncol, int nlev,
           int block_cols, float dt, float dz, int is_limited, int chen,
           int has_affine, float scale, float bias, int device, void* stream) {
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (ncol + block_cols - 1) / block_cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_limited && chen)
    column2m_step_kernel<true, true><<<grid, kThreads, 0, s>>>(
        f, params, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  else if (is_limited)
    column2m_step_kernel<true, false><<<grid, kThreads, 0, s>>>(
        f, params, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  else if (chen)
    column2m_step_kernel<false, true><<<grid, kThreads, 0, s>>>(
        f, params, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  else
    column2m_step_kernel<false, false><<<grid, kThreads, 0, s>>>(
        f, params, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column2m_threads_per_block() { return kThreads; }

int column2m_num_params() { return N_PARAMS; }

// K4: seven (ncol, nlev) inputs and seven outputs, in ColumnState2M order.
int column2m_step_unpacked(const float* rho, const float* T, const float* q_tot,
                           const float* q_lcl, const float* n_lcl,
                           const float* q_rai, const float* n_rai,
                           float* rho_out, float* T_out, float* q_tot_out,
                           float* q_lcl_out, float* n_lcl_out,
                           float* q_rai_out, float* n_rai_out,
                           const float* params, int ncol, int nlev,
                           int block_cols, float dt, float dz, int is_limited,
                           int chen, int has_affine, float scale, float bias,
                           int device, void* stream) {
  Fields f = {{rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai},
              {rho_out, T_out, q_tot_out, q_lcl_out, n_lcl_out, q_rai_out,
               n_rai_out}};
  return launch(f, params, ncol, nlev, block_cols, dt, dz, is_limited, chen,
                has_affine, scale, bias, device, stream);
}

// K3: one (7, ncol, nlev) input and output; field i starts at i * plane.
int column2m_step_packed(const float* in, float* out, long long plane,
                         const float* params, int ncol, int nlev,
                         int block_cols, float dt, float dz, int is_limited,
                         int chen, int has_affine, float scale, float bias,
                         int device, void* stream) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = in + i * plane;
    f.out[i] = out + i * plane;
  }
  return launch(f, params, ncol, nlev, block_cols, dt, dz, is_limited, chen,
                has_affine, scale, bias, device, stream);
}

}  // extern "C"
