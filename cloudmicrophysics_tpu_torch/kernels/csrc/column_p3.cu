// Fused 2-moment warm rain + P3 ice column step: one explicit Euler step of
// models/column.py:step_column_p3 over (ncol, nlev) f32 columns of the
// eleven prognostic fields (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
// q_ice, n_ice, q_rim, b_rim), with an optional warm-start log lambda, to
// the eleven new fields and the solved log lambda.
//
// Replaces the Pallas TPU kernel cloudmicrophysics_tpu/kernels/column_p3.py:
// step_column_p3_pallas, which re-runs the XLA step on a tile. Per cell:
//   1. the P3 shape solve (fixed 8-iteration branchless Brent over the
//      segment-summed log mass moment, warm-started when a guess is given);
//   2. the sanitized state and its tail-quantile integration bounds
//      (4 Halley steps of the inverse incomplete gamma);
//   3. one pass over the ice quadrature nodes (4 segments x N nodes), each
//      node's Chen 2022 + aspect-ratio velocity and PSD weight evaluated
//      once and contracted by every consumer: liquid x ice collisions (N_L
//      cloud and N_L rain nodes per ice node, Musil freezing/shedding split,
//      wet growth), blocked self-collection (cross-segment prefix moments and
//      within-segment triangles of fresh inner nodes), melt, and the number-
//      and mass-weighted fall speeds;
//   4. F23 deposition nucleation, F23-capped Bigg immersion freezing,
//      sublimation/deposition, ice number adjustment, Bigg rain freezing,
//      the SB2006 warm rates (warm2m.cuh, shared with column2m.cu), rain and
//      ice sedimentation, latent heating, the clamp and q_rim <= q_ice.
//
// What bounds it on an H100: not HBM (48 B read and 48 B written per cell)
// but the instruction stream: some ten shape-solve residuals of six
// fixed-trip incomplete gammas each, four inverse incomplete gammas, and
// per ice node a dozen exp/log/pow calls plus those of its inner nodes. The
// design keeps the per-cell node table out of memory altogether: every
// consumer contracts the node axis, so one streaming pass over the nodes
// accumulates all of them, and only the per-cell liquid node factors (at
// most 2 x 8 x 4 floats) are held across the pass. Heavy device functions
// are __noinline__ to keep the three compiled variants (quadrature orders
// 4, 8, 16) quick to build; the warm-rain options are run-time branches.
//
// Rounding: it is built with --fmad=false and without fast math, and each
// expression follows the eager PyTorch step's operation order as PyTorch's
// CUDA kernels evaluate it (see warm2m.cuh), with the parameters folded on
// the host as the eager code folds its Python floats. Every node-axis sum
// of the eager step runs one node at a time in node order
// (utils/quadrature.py:sum_nodes), as this kernel's accumulators do. Where
// an operation still rounds differently, discrete arms can flip on a
// last-bit difference: the wet-growth test dM_col > dM_frz
// (ops/p3_processes.py), the regime select at the segment thresholds, and
// the Brent accept test.
//
// Infinities: D_gr and D_cr are +inf for unrimed ice, collapsed segments
// carry zero weight and -inf log moments (excluded from the logsumexp), and
// cells without ice run on the placeholder state of p3_step_aux and are
// masked, as in the eager step.
//
// Layout as in column1m.cu/column2m.cu: a thread owns one (column, level)
// cell; a block of kThreads threads covers block_cols whole columns in
// passes of kThreads / nlev columns; the six sedimentation fluxes of level
// k + 1 (rain mass and number at the rain speeds; ice mass, ice number,
// rime mass and rime volume at the ice speeds, rime at the mass-weighted
// one) come through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column_p3_params.h"
#include "warm2m.cuh"

namespace {

using namespace warm2m;

constexpr int kThreads = 256;
constexpr int kFields = 11;
constexpr int kFluxes = 6;
constexpr int kSegments = 4;
// offsets of the second parameter blocks (ice rain PSD, ice Chen rain)
constexpr int kIceRainPDF = P_IR_XR_MIN - P_XR_MIN;
constexpr int kIceChen = P_IC_RHO0 - P_CH_RHO0;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f_nan() { return __int_as_float(0x7fffffff); }

// Quadrature orders of a compiled variant: ice nodes per segment, liquid
// nodes, self-collection inner nodes (tail segment: NT)
template <int N>
struct Orders {
  static constexpr int NL = N > 8 ? (N / 2 > 8 ? N / 2 : 8) : N;
  static constexpr int NI = N / 4 > 4 ? N / 4 : 4;
  static constexpr int NT = N / 4 > 6 ? N / 4 : 6;
  // offsets into the node/weight tables behind the scalar parameters
  static constexpr int Y_ICE = 0, W_ICE = N;
  static constexpr int Y_LIQ = 2 * N, W_LIQ = 2 * N + NL;
  static constexpr int Y_IN = 2 * N + 2 * NL, W_IN = Y_IN + NI;
  static constexpr int Y_TAIL = W_IN + NI, W_TAIL = Y_TAIL + NT;
  static constexpr int LEN = W_TAIL + NT;
};

// ---------------------------------------------------------------------------
// utils/special.py: Lanczos log-gamma, fixed-trip incomplete gamma and its
// Halley inverse
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lgamma_pos(const float* __restrict__ P, float z) {
  constexpr float c[9] = {
      (float)0.99999999999980993, (float)676.5203681218851,
      (float)-1259.1392167224028, (float)771.32342877765313,
      (float)-176.61502916214059, (float)12.507343278686905,
      (float)-0.13857109526572012, (float)9.9843695780195716e-6,
      (float)1.5056327351493116e-7};
  z = maxf(z, PV(TINY)) - 1.0f;
  float series = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) series = series + rdiv(c[i], z + (float)i);
  const float t = z + 7.0f + 0.5f;
  return PV(HALF_LOG_2PI) + (z + 0.5f) * logf(t) - t + logf(series);
}

struct PQ {
  float p, q;
};

// utils/special.py:_gamma_inc_core at float32 (20 series and 20 Lentz
// iterations, both branches evaluated, no early exit)
__device__ __noinline__ PQ gamma_inc_core(const float* __restrict__ P, float a,
                                          float x, float lga) {
  const float tmin = PV(TINY);
  const float tiny = PV(GI_TINY);
  const bool use_series = x < a + 1.0f;
  const float factor = expf(a * logf(maxf(x, tmin)) - x - lga);

  const float x_s = use_series ? x : a;
  const float a_safe = maxf(a, tmin);
  float term = rdiv(1.0f, a_safe);
  float sum_p = term;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    term = term * x_s / (a_safe + (float)k);
    sum_p = sum_p + term;
  }
  const float P_series = clampf(factor * sum_p, 0.0f, 1.0f);

  const float x_c = use_series ? a + 2.0f : x;
  const float b1 = x_c + 1.0f - a;
  float c = b1 + PV(GI_BIG);
  float d = rdiv(1.0f, fabsf(b1) < tiny ? tiny : b1);
  float h = d;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    const float ak = (float)(-k) * ((float)k - a);
    const float bk = x_c + (float)(2 * k) + 1.0f - a;
    const float d_tmp = bk + ak * d;
    d = fabsf(d_tmp) < tiny ? tiny : d_tmp;
    const float c_tmp = bk + ak / c;
    c = fabsf(c_tmp) < tiny ? tiny : c_tmp;
    d = rdiv(1.0f, d);
    h = h * (c * d);
  }
  const float Q_cf = clampf(factor * h, 0.0f, 1.0f);

  PQ r;
  r.p = use_series ? P_series : 1.0f - Q_cf;
  r.q = use_series ? 1.0f - P_series : Q_cf;
  if (x <= 0.0f) {
    r.p = 0.0f;
    r.q = 1.0f;
  }
  if (x == f_inf()) {
    r.p = 1.0f;
    r.q = 0.0f;
  }
  if (isnan(x) || isnan(a)) r.p = r.q = f_nan();
  return r;
}

__device__ __forceinline__ float poly6(const float (&cs)[6], float x) {
  float r = cs[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) r = r * x + cs[i];
  return r;
}

__device__ __forceinline__ float poly5(const float (&cs)[5], float x) {
  float r = cs[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) r = r * x + cs[i];
  return r;
}

__device__ __forceinline__ float poly4(const float (&cs)[4], float x) {
  float r = cs[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) r = r * x + cs[i];
  return r;
}

// utils/special.py:_ndtri_acklam
__device__ __forceinline__ float ndtri_acklam(const float* __restrict__ P, float p) {
  constexpr float A[6] = {(float)-3.969683028665376e+01, (float)2.209460984245205e+02,
                          (float)-2.759285104469687e+02, (float)1.383577518672690e+02,
                          (float)-3.066479806614716e+01, (float)2.506628277459239e+00};
  constexpr float B[5] = {(float)-5.447609879822406e+01, (float)1.615858368580409e+02,
                          (float)-1.556989798598866e+02, (float)6.680131188771972e+01,
                          (float)-1.328068155288572e+01};
  constexpr float C[6] = {(float)-7.784894002430293e-03, (float)-3.223964580411365e-01,
                          (float)-2.400758277161838e+00, (float)-2.549732539343734e+00,
                          (float)4.374664141464968e+00, (float)2.938163982698783e+00};
  constexpr float D[4] = {(float)7.784695709041462e-03, (float)3.224671290700398e-01,
                          (float)2.445134137142996e+00, (float)3.754408661907416e+00};
  constexpr float lo_tail = (float)0.02425;
  constexpr float hi_tail = (float)(1.0 - 0.02425);
  const float p_c = clampf(p, PV(TINY), PV(ONE_M_EPS));
  const float qc = p_c - 0.5f;
  const float r = qc * qc;
  const float x_mid = qc * poly6(A, r) / (poly5(B, r) * r + 1.0f);
  const float ql = sqrtf(-2.0f * logf(p_c < lo_tail ? p_c : 0.01f));
  const float x_lo = poly6(C, ql) / (poly4(D, ql) * ql + 1.0f);
  const float qu = sqrtf(-2.0f * logf(p_c > hi_tail ? 1.0f - p_c : 0.01f));
  const float x_hi = -poly6(C, qu) / (poly4(D, qu) * qu + 1.0f);
  return p_c < lo_tail ? x_lo : (p_c > hi_tail ? x_hi : x_mid);
}

// utils/special.py:gamma_inc_inv with 4 Halley iterations (the integration
// bounds' count)
__device__ __noinline__ float gamma_inc_inv4(const float* __restrict__ P, float a,
                                             float p, float q) {
  const float tiny = PV(TINY);
  const float eps = PV(EPS_MACH);
  const float p_safe = maxf(p, tiny);
  const float q_safe = maxf(q, tiny);
  const float lga = lgamma_pos(P, a);
  const float a_safe = maxf(a, tiny);
  const float guess_lo = expf((logf(p_safe) + lgamma_pos(P, a + 1.0f)) / a_safe);
  const float z = -ndtri_acklam(P, q_safe);
  const float t_wh = 1.0f - rdiv(1.0f, 9.0f * a_safe) + z / (3.0f * sqrtf(a_safe));
  const float guess_ref = a - logf(q_safe);
  float guess_hi = t_wh > 0.1f ? a * (t_wh * t_wh * t_wh) : guess_ref;
  const float L_tail = -logf(q_safe);
  const float guess_tail = L_tail + (a - 1.0f) * logf(maxf(L_tail, 1.0f)) - lga;
  if (L_tail > 60.0f && guess_tail > 3.0f * a) guess_hi = maxf(guess_tail, tiny);
  float x = (p < 0.5f || guess_lo < 0.5f) ? guess_lo : guess_hi;
  x = maxf(x, tiny);

  const bool use_q = p > 0.5f;
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    const PQ g = gamma_inc_core(P, a, x, lga);
    const float f = use_q ? g.q - q : g.p - p;
    const float x_pos = maxf(x, tiny);
    const float fm = expf((a - 1.0f) * logf(x_pos) - x - lga);
    const float fprime = use_q ? -fm : fm;
    const bool fp_zero = fprime == 0.0f;
    const float fps = fp_zero ? 1.0f : fprime;
    const float f2 = (a - 1.0f - x) / x_pos;
    const float denom = 1.0f - 0.5f * f / fps * f2;
    float step = f / (fps * denom);
    step = (x - step <= 0.0f) ? 0.5f * x : step;
    const float x_new = x - step;
    const bool done_pre = done || fp_zero;
    x = done_pre ? x : x_new;
    done = done_pre || fabsf(step) < eps * x_new;
  }
  if (p <= 0.0f) x = 0.0f;
  if (q <= 0.0f) x = f_inf();
  if (isnan(a) || isnan(p) || isnan(q)) x = f_nan();
  return x;
}

// ---------------------------------------------------------------------------
// ops/p3.py: the P3 state, regime laws and size distribution
// ---------------------------------------------------------------------------

struct P3S {
  float L, N, F, rho_rim, rho_g, D_th, D_gr, D_cr;
};

// utils/special.py:sgs_weight_function with a_half = machine eps
__device__ __forceinline__ float sgs_weight(const float* __restrict__ P, float a) {
  const float eps = PV(EPS_MACH);
  const float a_s = clampf(a, eps, PV(SGS_UPPER));
  float inner = 1.0f - 2.0f * tpow(1.0f - a_s, PV(SGS_K));
  inner = clampf(inner, PV(SGS_LO), PV(ONE_M_EPS));
  float w = (1.0f + tanhf(2.0f * atanhf(inner))) * 0.5f;
  w = a < 0.0f ? 0.0f : w;
  w = 4.0f * a < eps ? 0.0f : w;
  return a > PV(SGS_HI) ? 1.0f : w;
}

// utils/special.py:regularised_ratio (half = eps, eps = eps^2)
__device__ __forceinline__ float regularised_ratio(const float* __restrict__ P,
                                                   float num, float den) {
  const float w = sgs_weight(P, den);
  const bool small = den < PV(EPS2);
  const float out = w * num / (small ? 1.0f : den);
  return small ? 0.0f : out;
}

__device__ __forceinline__ float exprel1(float x) {
  const bool small = fabsf(x) < 1e-8f;
  const float xs = small ? 1.0f : x;
  const float out = expm1f(xs) / xs;
  return small ? 1.0f + x * 0.5f : out;
}

__device__ __forceinline__ float exprel2(float x) {
  // 1/(i+1)! for i = 8 .. 1, Horner order
  constexpr float c[8] = {(float)(1.0 / 362880.0), (float)(1.0 / 40320.0),
                          (float)(1.0 / 5040.0),   (float)(1.0 / 720.0),
                          (float)(1.0 / 120.0),    (float)(1.0 / 24.0),
                          (float)(1.0 / 6.0),      (float)(1.0 / 2.0)};
  const bool small = fabsf(x) < 0.2f;
  const float xs = small ? 1.0f : x;
  const float direct = (expm1f(xs) - xs) / (xs * xs);
  float taylor = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) taylor = taylor * x + c[i];
  return small ? taylor : direct;
}

// ops/p3.py:_threshold
__device__ __forceinline__ float threshold(const float* __restrict__ P, float rho) {
  return tpow(rdiv(PV(SIX_ALPHA), rho * PV(PI_F)), PV(THR_EXP));
}

// ops/p3.py:state_from_prognostic (+ p3_state, get_rho_d, get_rho_g)
__device__ __noinline__ P3S state_from_prognostic(const float* __restrict__ P,
                                                  float L, float N, float L_rim,
                                                  float B_rim) {
  const float eps = PV(EPS_MACH);
  P3S s;
  s.L = L;
  s.N = N;
  s.F = minf(regularised_ratio(P, minf(L_rim, L), L), PV(ONE_M_EPS));
  s.rho_rim = minf(regularised_ratio(P, L_rim, B_rim), PV(RHO_RIM_MAX));
  // get_rho_d
  const float F = minf(s.F, PV(ONE_M_EPS));
  const float logFu = log1pf(-F);
  const float phi1 = exprel1(logFu);
  const float phi1mp = exprel1(PV(RHOD_1MP) * logFu);
  const float H = PV(RHOD_NEGP) * exprel2(PV(RHOD_NEGP) * logFu) -
                  PV(RHOD_1MP) * exprel2(PV(RHOD_1MP) * logFu);
  const float G = H - phi1mp * phi1;
  const float rho_d = -(s.rho_rim * phi1 * phi1mp) / G;
  s.rho_g = s.F * s.rho_rim + (1.0f - s.F) * rho_d;
  s.D_th = PV(D_TH);
  const bool unrimed = s.F == 0.0f;
  const float rgs = unrimed ? 1.0f : s.rho_g;
  s.D_gr = unrimed ? f_inf() : threshold(P, rgs);
  s.D_cr = unrimed ? f_inf() : threshold(P, rgs * maxf(1.0f - s.F, eps));
  return s;
}

template <typename T>
__device__ __forceinline__ T regime(const P3S& s, float D, T small, T unrimed,
                                    T dense, T graupel, T partial) {
  return D < s.D_th ? small
                    : (s.F == 0.0f ? unrimed
                                   : (D < s.D_gr ? dense : (D < s.D_cr ? graupel : partial)));
}

struct MassCoeffs {
  float a, b;
};

// ops/p3.py:ice_mass_coeffs
__device__ __forceinline__ MassCoeffs mass_coeffs(const float* __restrict__ P,
                                                  const P3S& s, float D) {
  const float alpha = PV(ALPHA_VA), beta = PV(BETA_VA);
  const float Fu = maxf(1.0f - s.F, PV(EPS_MACH));
  MassCoeffs m;
  m.a = regime(s, D, PV(RHOI_PI6), alpha, alpha, s.rho_g * PV(PI_F) * kSixth,
               rdiv(alpha, Fu));
  m.b = regime(s, D, 3.0f, beta, beta, 3.0f, beta);
  return m;
}

// ops/p3.py:ice_area
__device__ __forceinline__ float ice_area(const float* __restrict__ P, const P3S& s,
                                          float D) {
  const float sph = D * D * PV(PI_F) * 0.25f;
  const float non = PV(AREA_GAMMA) * tpow(D, PV(AREA_SIGMA));
  return regime(s, D, sph, non, non, sph, s.F * sph + (1.0f - s.F) * non);
}

// ops/common.py:chen2022_vel_coeffs_small_ice / _large_ice at the cell's air
// density: the a_i, b_i and c_i of the two small-ice and two large-ice terms
struct IceVel {
  float as0, as1, bs, al0, al1;
};

__device__ __forceinline__ IceVel ice_vel_coeffs(const float* __restrict__ P,
                                                 float rho) {
  const float rho_a = maxf(rho, 0.0f);
  const float log_rho = logf(rho_a);
  IceVel c;
  const float bi_common = rho_a * PV(CS_C) + PV(CS_B);
  const float rho_pow_s = expf(PV(CS_A) * log_rho);
  const float unit = expf(bi_common * PV(LOG1000));
  c.as0 = PV(CS_E) * rho_pow_s * unit;
  c.as1 = PV(CS_F) * rho_pow_s * unit;
  c.bs = bi_common;
  const float rho_pow_l = expf(PV(CL_A) * log_rho);
  c.al0 = PV(CL_B) * rho_pow_l * PV(CL_U0);
  c.al1 = PV(CL_E) * rho_pow_l * expf(PV(CL_H) * rho_a) * PV(CL_U1);
  return c;
}

// What one evaluation of the ice particle at diameter D gives: its Chen 2022
// + aspect-ratio fall speed, mass and cross-sectional area
struct IceParticle {
  float v, m, area;
};

// ops/p3.py:ice_particle_terminal_velocity (with phi_i, ice_mass, ice_area)
__device__ __noinline__ IceParticle ice_particle(const float* __restrict__ P,
                                                 const P3S& s, const IceVel& c,
                                                 float D) {
  const float log_D = logf(D);
  const float v_small = c.as0 * expf(c.bs * log_D - PV(CS_C0U) * D) +
                        c.as1 * expf(c.bs * log_D - PV(CS_C1U) * D);
  const float v_large = c.al0 * expf(PV(CL_B0) * log_D - PV(CL_C0U) * D) +
                        c.al1 * expf(PV(CL_B1) * log_D - PV(CL_C1U) * D);
  const float v = D <= PV(CUTOFF) ? v_small : v_large;
  const MassCoeffs mc = mass_coeffs(P, s, D);
  IceParticle o;
  o.m = mc.a * powf(D, mc.b);
  o.area = ice_area(P, s, D);
  const float rho = regime(s, D, PV(RHO_I), PV(RHO_I), PV(RHO_I), s.rho_g, PV(RHO_I));
  const float a_safe = maxf(o.area, PV(TINY));
  float phi = PV(THREE_SQRT_PI) * o.m / (4.0f * rho * a_safe * sqrtf(a_safe));
  phi = D == 0.0f ? 0.0f : phi;
  const float sgn = (float)((0.0f < phi) - (phi < 0.0f));
  o.v = v * (sgn * tpow(fabsf(phi), kThird));
  return o;
}

// ops/p3.py:get_mu (power-law slope)
__device__ __forceinline__ float get_mu(const float* __restrict__ P, float ll) {
  return clampf(PV(SLOPE_A) * tpow(expf(ll), PV(SLOPE_B)) - PV(SLOPE_C), 0.0f,
                PV(MU_MAX));
}

// ops/p3.py:loggamma_moment (k = 0, scale = 1)
__device__ __forceinline__ float loggamma_moment(float mu, float ll) {
  const float z = mu + 0.0f + 1.0f;
  return -z * ll + lgammaf(z) + 0.0f;
}

// ops/p3.py:logLdivN: segment-summed log mass moment minus log number
// moment; the logsumexp adds the segments in order
__device__ __noinline__ float logLdivN(const float* __restrict__ P, const P3S& s,
                                       float ll) {
  const float mu = get_mu(P, ll);
  const float e = expf(ll);
  const float inf = f_inf();
  const float bnds[5] = {0.0f, minf(maxf(s.D_th, 0.0f), inf),
                         minf(maxf(s.D_gr, 0.0f), inf),
                         minf(maxf(s.D_cr, 0.0f), inf), inf};
  float m[kSegments];
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    const float lo = bnds[i], hi = bnds[i + 1];
    const MassCoeffs mc = mass_coeffs(P, s, (lo + hi) * 0.5f);
    const float z = mc.b + 0.0f + mu + 1.0f;
    const float lgz = lgamma_pos(P, z);
    PQ g1, g2;
    float x2;
    if (i == 0) {
      g1.p = 0.0f;
      g1.q = 1.0f;
    } else {
      g1 = gamma_inc_core(P, z, lo * e, lgz);
    }
    if (i == kSegments - 1) {
      g2.p = 1.0f;
      g2.q = 0.0f;
      x2 = inf;
    } else {
      x2 = hi * e;
      g2 = gamma_inc_core(P, z, x2, lgz);
    }
    float dq = x2 < z + 1.0f ? g2.p - g1.p : g1.q - g2.q;
    dq = maxf(dq, PV(EPS_MACH));
    float out = -z * ll + lgammaf(z) + logf(dq) + 0.0f;
    out = lo < hi ? out : -inf;
    out = out + logf(maxf(mc.a, PV(TINY)));
    m[i] = lo < hi ? out : -inf;
  }
  // utils/special.py:logsumexp
  float xmax = m[0];
#pragma unroll
  for (int i = 1; i < kSegments; ++i) xmax = m[i] > xmax ? m[i] : xmax;
  const bool finite = isfinite(xmax);
  const float shift = finite ? xmax : 0.0f;
  float sum = expf(m[0] - shift);
#pragma unroll
  for (int i = 1; i < kSegments; ++i) sum = sum + expf(m[i] - shift);
  const float lse = finite ? shift + logf(sum) : xmax;
  return lse - loggamma_moment(mu, ll);
}

// ops/p3.py:get_distribution_loglambda: fixed 8-iteration branchless Brent
// over [2, 17], narrowed by the warm-start guess when there is one
__device__ __noinline__ float shape_solve(const float* __restrict__ P, const P3S& s,
                                          bool warm_start, float guess) {
  const float tiny = PV(TINY);
  const bool empty = s.N < PV(EN) || s.L < PV(EM);
  if (empty) return -f_inf();
  const float target = logf(maxf(s.L, tiny)) - logf(maxf(s.N, tiny));
  float lo = 2.0f, hi = 17.0f;
  float f_lo = logLdivN(P, s, lo) - target;
  float f_hi = logLdivN(P, s, hi) - target;
  const bool degenerate = !isfinite(f_lo) || !isfinite(f_hi) || f_lo * f_hi > 0.0f;
  const float endpoint = fabsf(f_lo) <= fabsf(f_hi) ? lo : hi;
  if (degenerate) return endpoint;
  if (warm_start) {
    const float p = guess + 0.0f;
    bool valid = isfinite(p) && lo < p && p < hi;
    const float pc = valid ? p : lo;
    const float f_p = logLdivN(P, s, pc) - target;
    valid = valid && isfinite(f_p);
    const bool left = valid && f_lo * f_p < 0.0f;
    const bool right = valid && !left;
    hi = left ? pc : hi;
    f_hi = left ? f_p : f_hi;
    lo = right ? pc : lo;
    f_lo = right ? f_p : f_lo;
  }
  // _brent_fixed
  float a = lo, fa = f_lo, b = hi, fb = f_hi, c = b, fc = fb;
  float d = b - a, e = b - a;
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const bool same_sign = fb * fc > 0.0f;
    if (same_sign) {
      c = a;
      fc = fa;
      d = b - a;
      e = b - a;
    }
    if (fabsf(fc) < fabsf(fb)) {
      a = b;
      b = c;
      c = a;
      fa = fb;
      fb = fc;
      fc = fa;
    }
    const float tol1 = PV(TWO_EPS) * fabsf(b);
    const float xm = (c - b) * 0.5f;
    const bool can_interp = fabsf(e) >= tol1 && fabsf(fa) > fabsf(fb);
    const float fa_safe = fabsf(fa) > 0.0f ? fa : tiny;
    const float fc_safe = fabsf(fc) > 0.0f ? fc : tiny;
    const float sr = fb / fa_safe;
    const bool secant = a == c;
    const float p_sec = 2.0f * xm * sr;
    const float q_sec = 1.0f - sr;
    const float q_i = fa / fc_safe;
    const float r_i = fb / fc_safe;
    const float p_iqi = sr * (2.0f * xm * q_i * (q_i - r_i) - (b - a) * (r_i - 1.0f));
    const float q_iqi = (q_i - 1.0f) * (r_i - 1.0f) * (sr - 1.0f);
    float pp = secant ? p_sec : p_iqi;
    float qq = secant ? q_sec : q_iqi;
    qq = pp > 0.0f ? -qq : qq;
    pp = fabsf(pp);
    const float q_safe = fabsf(qq) > 0.0f ? qq : tiny;
    const bool accept =
        can_interp && 2.0f * pp < minf(3.0f * xm * qq - fabsf(tol1 * qq), fabsf(e * qq));
    const float e_new = accept ? d : xm;
    const float d_new = accept ? pp / q_safe : xm;
    a = b;
    fa = fb;
    const float step = fabsf(d_new) > tol1 ? d_new : (xm >= 0.0f ? tol1 : -tol1);
    b = b + step;
    fb = logLdivN(P, s, b) - target;
    d = d_new;
    e = e_new;
  }
  return fabsf(fb) <= fabsf(fc) ? b : c;
}

// ---------------------------------------------------------------------------
// ops/m2.py and ops/ice_nucleation.py pieces on the cloud PSD
// ---------------------------------------------------------------------------

struct CloudPDF {
  float logN0c, lam_c;
};

// ops/m2.py:pdf_cloud_parameters (log_pdf_cloud_parameters_mass inside)
__device__ __forceinline__ CloudPDF pdf_cloud(const float* __restrict__ P, float q,
                                              float rho, float N) {
  const float em = PV(EM), en = PV(EN);
  const float safe_q = maxf(q, em);
  const float safe_N = maxf(N, en);
  const float L = rho * safe_q;
  const float log_xbar = logf(L / safe_N);
  float logB = PV(CPDF_NEG_MU) * (log_xbar + PV(CPDF_LG1) - PV(CPDF_LG2));
  float logA = logf(PV(CPDF_MU)) + logf(safe_N) + PV(CPDF_Z1) * logB - PV(CPDF_LG1);
  const bool cond = N < en || q < em;
  logA = cond ? -f_inf() : logA;
  logB = cond ? f_inf() : logB;
  CloudPDF c;
  c.logN0c = logA + logf(3.0f) + PV(CPDF_NU1) * logf(PV(CPDF_KM));
  c.lam_c = expf(logB) * PV(CPDF_KM_POW_MU);
  return c;
}

// ops/m2.py:size_distribution_cloud at D
__device__ __forceinline__ float n_cloud(const float* __restrict__ P, const CloudPDF& c,
                                         float D) {
  const float D_safe = maxf(D, PV(TINY));
  const float lam_safe = isinf(c.lam_c) ? 0.0f : c.lam_c;
  const float v = expf(c.logN0c + PV(CPDF_NUD) * logf(D_safe) -
                       lam_safe * tpow(D_safe, PV(CPDF_MUD)));
  return (isinf(c.logN0c) && c.logN0c < 0.0f) ? 0.0f : v;
}

// ops/p3_processes.py:compute_local_rime_density's Cober & List law at Ri
__device__ __forceinline__ float rho_rim_local(const float* __restrict__ P, float Ri) {
  Ri = clampf(Ri, 1.0f, 12.0f);
  const float cl93 = PV(RRL_B) * Ri + PV(RRL_A) + PV(RRL_C) * (Ri * Ri);
  const float f = (Ri - 8.0f) * 0.25f;
  const float ext = (1.0f - f) * PV(RRL_RHO8) + f * PV(RRL_RHO_ICE);
  return Ri <= 8.0f ? cl93 : ext;
}

// ops/thermo.py:saturation_vapor_pressure_over_ice
__device__ __forceinline__ float p_sat_ice(const float* __restrict__ P, float T) {
  return PV(PRESS_TRIPLE) * expf(PV(KV_I) * logf(T * PV(INV_T_TRIPLE)) +
                                 PV(CL_I) * (PV(INV_T_TRIPLE) - 1.0f / T));
}

// ops/ice_nucleation.py:INP_concentration_mean
__device__ __forceinline__ float inp_mean(const float* __restrict__ P, float T) {
  const float T_c = minf(T - PV(F23_T_FREEZE), 0.0f);
  const float arg = maxf(PV(F23_NEG_B) * T_c * PV(INV_TEN), PV(TINY));
  return 9.0f * logf(arg) - PV(F23_LOG_A);
}

// ---------------------------------------------------------------------------
// The cell step
// ---------------------------------------------------------------------------

struct CellIn {
  float rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, b_rim;
};

struct CellOut {
  float loglam;
  float T_new;
  float dq_lcl, dn_lcl, dq_rai, dn_rai, dq_ice, dn_ice, dq_rim, db_rim;
  float F[kFluxes];  // downward fluxes: q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
};

// Per-cell liquid node factors of the collision integral, evaluated once and
// held across the ice node pass
template <int NL>
struct LiquidNodes {
  float D[NL], v[NL], nw[NL], nwm[NL];
};

template <int N>
__device__ __forceinline__ CellOut cell_step(const float* __restrict__ P, const CellIn& x,
                                             bool warm_start, float guess, float dt,
                                             int limited, int chen) {
  using O = Orders<N>;
  const float* __restrict__ TAB = P + N_PARAMS;
  const float em = PV(EM), en = PV(EN), tiny = PV(TINY);
  CellOut o;

  // ---- 1. shape solve on the raw state (models/column.py) -------------
  {
    const P3S raw = state_from_prognostic(P, x.q_ice * x.rho, x.n_ice * x.rho,
                                          x.q_rim * x.rho, x.b_rim * x.rho);
    o.loglam = shape_solve(P, raw, warm_start, guess);
  }

  // ---- 2. bulk_tendencies_2m clamps + the warm rates -------------------
  const float rho = maxf(x.rho, 0.0f);
  const float q_tot = maxf(x.q_tot, 0.0f);
  const float q_lcl = maxf(x.q_lcl, 0.0f);
  const float q_rai = maxf(x.q_rai, 0.0f);
  const float n_lcl = maxf(x.n_lcl, 0.0f);
  const float n_rai = maxf(x.n_rai, 0.0f);
  const float q_ice = maxf(x.q_ice, 0.0f);
  const float n_ice = maxf(x.n_ice, 0.0f);
  const WarmRates w =
      limited ? warm_rates<true>(P, x.rho, x.T, x.q_tot, x.q_lcl, x.n_lcl, x.q_rai, x.n_rai, q_ice)
              : warm_rates<false>(P, x.rho, x.T, x.q_tot, x.q_lcl, x.n_lcl, x.q_rai, x.n_rai, q_ice);
  const float T = x.T;

  // ---- 3. p3_step_aux: the sanitized state and its bounds --------------
  const float L_ice = q_ice * x.rho, N_ice = n_ice * x.rho;
  const float L_rim = maxf(x.q_rim, 0.0f) * x.rho, B_rim = maxf(x.b_rim, 0.0f) * x.rho;
  const bool has_ice = q_ice > em && n_ice > en;
  const P3S s = state_from_prognostic(P, has_ice ? L_ice : 1e-6f, has_ice ? N_ice : 1e3f,
                                      has_ice ? L_rim : 0.0f, has_ice ? B_rim : 0.0f);
  const float ll = (has_ice && isfinite(o.loglam)) ? o.loglam : 8.0f;
  const float mu = get_mu(P, ll);
  const float lam = expf(ll);
  float bnds[kSegments + 1];
  {
    const float k1 = mu + 0.0f + 1.0f;
    const float D_min = gamma_inc_inv4(P, k1, PV(IB_P_LO), PV(IB_Q_LO)) / lam;
    const float D_max = gamma_inc_inv4(P, k1, PV(IB_P_HI), PV(IB_Q_HI)) / lam;
    bnds[0] = D_min;
    bnds[1] = minf(maxf(s.D_th, D_min), D_max);
    bnds[2] = minf(maxf(s.D_gr, D_min), D_max);
    bnds[3] = minf(maxf(s.D_cr, D_min), D_max);
    bnds[4] = D_max;
  }
  const float log_N0 = logf(maxf(s.N, tiny)) - loggamma_moment(mu, ll);
  const IceVel vc = ice_vel_coeffs(P, x.rho);

  // ---- 4. per-cell liquid factors of the collision integral ------------
  const float L_lcl = q_lcl * rho, N_lcl = n_lcl * rho;
  const float L_rai = q_rai * rho, N_rai = n_rai * rho;
  const ChenRain cr = chen_rain_coeffs<kIceChen>(P, rho);
  LiquidNodes<O::NL> cl, rn;
  bool rain_valid;
  {
    // cloud: Gauss nodes over the tail-quantile window of the cloud PSD
    const float q_c = L_lcl / rho;
    const CloudPDF cp = pdf_cloud(P, q_c, rho, N_lcl);
    const bool bad = isinf(cp.lam_c) || cp.lam_c <= 0.0f;
    const float lam_safe = bad ? 1.0f : cp.lam_c;
    float c_lo = tpow(gamma_inc_inv4(P, PV(CB_A), PV(CB_P_LO), PV(CB_Q_LO)) / lam_safe,
                      PV(CB_INV_MU));
    float c_hi = tpow(gamma_inc_inv4(P, PV(CB_A), PV(CB_P_HI), PV(CB_Q_HI)) / lam_safe,
                      PV(CB_INV_MU));
    c_lo = bad ? 0.0f : c_lo;
    c_hi = bad ? 0.0f : c_hi;
    const bool valid = c_lo < c_hi;
    const float a_s = valid ? c_lo : 1.0f, b_s = valid ? c_hi : 2.0f;
    const float scale = (b_s - a_s) * 0.5f, mid = (a_s + b_s) * 0.5f;
#pragma unroll
    for (int l = 0; l < O::NL; ++l) {
      const float D = scale * __ldg(TAB + O::Y_LIQ + l) + mid;
      const float wl = __ldg(TAB + O::W_LIQ + l) * scale;
      cl.D[l] = D;
      cl.nw[l] = n_cloud(P, cp, D) * (valid ? wl : 0.0f);
      cl.nwm[l] = cl.nw[l] * (PV(RHO_W) * (D * D * D * PV(PI_F) * kSixth));
      const float log_D = logf(D);
      cl.v[l] = cr.a[0] * expf(cr.b[0] * log_D - cr.c[0] * D) +
                cr.a[1] * expf(cr.b[1] * log_D - cr.c[1] * D) +
                cr.a[2] * expf(cr.b[2] * log_D - cr.c[2] * D);
    }
  }
  {
    // rain: Gauss nodes over the exponential PSD's window (ice rain PSD)
    const float q_r = L_rai / rho;
    const RainPDF rp = pdf_rain<true, kIceRainPDF>(P, q_r, rho, N_rai);
    const float Dm_safe = rp.Dr_mean > 0.0f ? rp.Dr_mean : 1.0f;
    const bool zero = rp.Dr_mean == 0.0f;
    const float r_lo = zero ? 0.0f : -Dm_safe * PV(LOG1P_NEG_P);
    const float r_hi = zero ? 0.0f : -Dm_safe * PV(LOG1P_NEG_1MP);
    rain_valid = rp.N0 > 0.0f && r_hi > r_lo;
    const float r_lo_s = rain_valid ? r_lo : 1.0f, r_hi_s = rain_valid ? r_hi : 2.0f;
    const bool valid = r_lo_s < r_hi_s;
    const float a_s = valid ? r_lo_s : 1.0f, b_s = valid ? r_hi_s : 2.0f;
    const float scale = (b_s - a_s) * 0.5f, mid = (a_s + b_s) * 0.5f;
#pragma unroll
    for (int l = 0; l < O::NL; ++l) {
      const float D = scale * __ldg(TAB + O::Y_LIQ + l) + mid;
      const float wl = __ldg(TAB + O::W_LIQ + l) * scale;
      rn.D[l] = D;
      const float log_D = logf(D);
      rn.v[l] = cr.a[0] * expf(cr.b[0] * log_D - cr.c[0] * D) +
                cr.a[1] * expf(cr.b[1] * log_D - cr.c[1] * D) +
                cr.a[2] * expf(cr.b[2] * log_D - cr.c[2] * D);
      const float nr = rp.N0 * expf(-D / Dm_safe);
      rn.nw[l] = (rp.N0 == 0.0f ? 0.0f : nr) * (valid ? wl : 0.0f);
      rn.nwm[l] = rn.nw[l] * (PV(RHO_W) * (D * D * D * PV(PI_F) * kSixth));
    }
  }

  // per-cell factors of the freezing limit, rime density and melt
  const float T_c = T - PV(P3_T_FREEZE);
  const float inv_2Tc = rdiv(1e6f, 2.0f * (fabsf(T_c) > 0.0f ? T_c : -PV(EPS_MACH)));
  const float Lf = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const float e_si = p_sat_ice(P, T);
  const float dT = PV(T_FRZ) - T;
  const float drho_v_sat = rho * (rdiv(PV(E_SI_FRZ), rho * PV(R_V) * PV(T_FRZ)) -
                                  e_si / (rho * PV(R_V) * T));
  const float frz_denom = Lf - PV(CP_L) * dT;
  const float frz_num = PV(K_THERM) * dT + w.Lv * PV(D_VAPOR) * drho_v_sat;

  // ---- 5. one pass over the ice nodes ----------------------------------
  float QCFRZ = 0.0f, QCSHD = 0.0f, NCCOL = 0.0f, QRFRZ = 0.0f, QRSHD = 0.0f;
  float NRCOL = 0.0f, INT_M = 0.0f, BCCOL = 0.0f, BRCOL = 0.0f, INT_WET = 0.0f;
  float acc_melt = 0.0f, acc_vn = 0.0f, acc_vm = 0.0f;
  float pre[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // prefix moments S0..S2, T0..T2
  float cross_seg[kSegments], tri_seg[kSegments];
#pragma unroll 1
  for (int sg = 0; sg < kSegments; ++sg) {
    const float lo = bnds[sg], hi = bnds[sg + 1];
    const bool valid = lo < hi;
    const float a_s = valid ? lo : 1.0f, b_s = valid ? hi : 2.0f;
    const float scale = (b_s - a_s) * 0.5f, mid = (a_s + b_s) * 0.5f;
    const int n_in = sg == kSegments - 1 ? O::NT : O::NI;
    const int y_in = sg == kSegments - 1 ? O::Y_TAIL : O::Y_IN;
    const int w_in = sg == kSegments - 1 ? O::W_TAIL : O::W_IN;
    float seg[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float cross = 0.0f, tri = 0.0f;
#pragma unroll 1
    for (int j = 0; j < N; ++j) {
      const float D = scale * __ldg(TAB + O::Y_ICE + j) + mid;
      const float wj = valid ? __ldg(TAB + O::W_ICE + j) * scale : 0.0f;
      const IceParticle ip = ice_particle(P, s, vc, D);
      const float v = ip.v;
      const float n = expf(log_N0 + mu * logf(maxf(D, tiny)) - lam * D);
      const float nw = n * wj;
      const float r = sqrtf(ip.area * PV(INV_PI));

      // -- liquid x ice collisions at this ice node
      const float k0 = PV(PI_F) * (r * r), k1 = PV(PI_F) * r;
      float dN_c = 0.0f, dM_c = 0.0f, dB_c = 0.0f, dN_r = 0.0f, dM_r = 0.0f, dB_r = 0.0f;
#pragma unroll
      for (int l = 0; l < O::NL; ++l) {
        const float Dl = cl.D[l];
        const float K = (PV(K2) * Dl + k1) * Dl + k0;
        const float v_rel = fabsf(v - cl.v[l]);
        const float dV = K * v_rel;
        const float t1 = dV * cl.nw[l];
        const float t2 = dV * cl.nwm[l];
        const float t3 = t2 / rho_rim_local(P, Dl * v_rel * inv_2Tc);
        dN_c = l == 0 ? t1 : dN_c + t1;
        dM_c = l == 0 ? t2 : dM_c + t2;
        dB_c = l == 0 ? t3 : dB_c + t3;
      }
#pragma unroll
      for (int l = 0; l < O::NL; ++l) {
        const float Dl = rn.D[l];
        const float K = (PV(K2) * Dl + k1) * Dl + k0;
        const float v_rel = fabsf(v - rn.v[l]);
        const float dV = K * v_rel;
        const float t1 = dV * rn.nw[l];
        const float t2 = dV * rn.nwm[l];
        const float t3 = t2 / rho_rim_local(P, Dl * v_rel * inv_2Tc);
        dN_r = l == 0 ? t1 : dN_r + t1;
        dM_r = l == 0 ? t2 : dM_r + t2;
        dB_r = l == 0 ? t3 : dB_r + t3;
      }
      if (!(isfinite(dN_r) && isfinite(dM_r)) || !rain_valid) {
        dN_r = 0.0f;
        dM_r = 0.0f;
        dB_r = 0.0f;
      }
      const float dM_col = dM_c + dM_r;
      const float F_v = PV(P3_VENT_A) + PV(P3_VENT_BC) * sqrtf(D * v * PV(INV_NU_AIR));
      float frz = 2.0f * (PV(PI_F) * D) * F_v * frz_num / (frz_denom > 0.0f ? frz_denom : 1.0f);
      frz = frz_denom > 0.0f ? frz : PV(BIG);
      frz = T >= PV(T_FRZ) ? 0.0f : frz;
      const float dM_frz = minf(dM_col, frz);
      const bool zero_col = dM_col == 0.0f;
      const float f_frz = zero_col ? 0.0f : dM_frz / (zero_col ? 1.0f : dM_col);
      const float wet = dM_col > dM_frz ? 1.0f : 0.0f;
      QCFRZ += nw * (dM_c * f_frz);
      QCSHD += nw * (dM_c * (1.0f - f_frz));
      NCCOL += nw * dN_c;
      QRFRZ += nw * (dM_r * f_frz);
      QRSHD += nw * (dM_r * (1.0f - f_frz));
      NRCOL += nw * dN_r;
      INT_M += nw * dM_col;
      BCCOL += nw * (dB_c * f_frz);
      BRCOL += nw * (dB_r * f_frz);
      INT_WET += nw * (wet * dM_col);

      // -- melt and the weighted fall speeds
      const MassCoeffs mc = mass_coeffs(P, s, D);
      acc_melt += mc.a * mc.b * powf(D, mc.b - 1.0f) * F_v * nw / D;
      acc_vn += nw * v;
      acc_vm += nw * v * ip.m;

      // -- self-collection, cross-segment blocks (prefix moments of the
      // lower segments) and this segment's moments
      const float nwr = nw * r, nwr2 = nwr * r;
      if (sg > 0) {
        const float ci = PV(PI_F) * (r * r * (v * pre[0] - pre[3]) +
                                     2.0f * r * (v * pre[1] - pre[4]) + (v * pre[2] - pre[5]));
        cross += ci * nw;
      }
      seg[0] += nw;
      seg[1] += nwr;
      seg[2] += nwr2;
      seg[3] += nw * v;
      seg[4] += nwr * v;
      seg[5] += nwr2 * v;

      // -- self-collection, within-segment triangle [a_seg, D]
      const float t_lo = lo + 0.0f;
      const bool t_valid = t_lo < D;
      const float ta = t_valid ? t_lo : 1.0f, tb = t_valid ? D : 2.0f;
      const float t_scale = (tb - ta) * 0.5f, t_mid = (ta + tb) * 0.5f;
      float acc = 0.0f;
#pragma unroll 1
      for (int i = 0; i < n_in; ++i) {
        const float D2 = t_scale * __ldg(TAB + y_in + i) + t_mid;
        const float w2 = t_valid ? __ldg(TAB + w_in + i) * t_scale : 0.0f;
        const IceParticle ip2 = ice_particle(P, s, vc, D2);
        const float r2 = sqrtf(ip2.area * PV(INV_PI));
        const float K = PV(PI_F) * ((r + r2) * (r + r2));
        const float n2 = expf(log_N0 + mu * logf(maxf(D2, tiny)) - lam * D2);
        acc = acc + K * fabsf(v - ip2.v) * n2 * w2;
      }
      tri += acc * nw;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) pre[i] = pre[i] + seg[i];
    cross_seg[sg] = cross;
    tri_seg[sg] = tri;
  }
  float agg = 0.0f;
#pragma unroll
  for (int sg = 1; sg < kSegments; ++sg) agg = agg + cross_seg[sg];
#pragma unroll
  for (int sg = 0; sg < kSegments; ++sg) agg = agg + tri_seg[sg];

  // ---- 6. collision sources (ops/p3_processes.py) ----------------------
  const bool zero_int = INT_M == 0.0f;
  const float f_wet = zero_int ? 0.0f : INT_WET / (zero_int ? 1.0f : INT_M);
  const float NRSHD = QRSHD * PV(INV_M_SHD);
  const bool has_rim = s.rho_rim > 0.0f;
  const float rr_safe = has_rim ? s.rho_rim : 1.0f;
  const float B_rim_c = has_rim ? s.L * s.F / rr_safe : 0.0f;
  const float QIWET = f_wet * s.L * (1.0f - s.F) * PV(INV_TAU_WET);
  const float BIWET = f_wet * (s.L * PV(INV_RHO_I) - B_rim_c) * PV(INV_TAU_WET);
  const float c_dq_c = (-QCFRZ - QCSHD) / rho;
  const float c_dq_r = (-QRFRZ + QCSHD) / rho;
  const float c_dN_c = -NCCOL;
  const float c_dN_r = -NRCOL + NRSHD;
  const float c_dL_rim = QCFRZ + QRFRZ + QIWET;
  const float c_dL_ice = QCFRZ + QRFRZ;
  const float c_dB_rim = BCCOL + BRCOL + BIWET;

  // ---- 7. ice_tendencies_2m_p3 (models/p3_tendencies.py) ---------------
  float dq_lcl = w.dq_lcl + (has_ice ? c_dq_c : 0.0f);
  float dq_rai = w.dq_rai + (has_ice ? c_dq_r : 0.0f);
  float dn_lcl = w.dn_lcl + (has_ice ? c_dN_c : 0.0f) / rho;
  float dn_rai = w.dn_rai + (has_ice ? c_dN_r : 0.0f) / rho;
  float dq_ice = 0.0f + (has_ice ? c_dL_ice : 0.0f) / rho;
  float dq_rim = 0.0f + (has_ice ? c_dL_rim : 0.0f) / rho;
  float db_rim = 0.0f + (has_ice ? c_dB_rim : 0.0f) / rho;
  float dn_ice = 0.0f - (has_ice ? agg : 0.0f) / rho;

  // melt (above freezing)
  {
    const float fac = rdiv(PV(FOUR_K_THERM), Lf) * (T - PV(P3_T_FREEZE));
    const float dLdt = maxf(fac * acc_melt, 0.0f);
    const float dNdt = s.N / maxf(s.L, tiny) * dLdt;
    const bool melting = has_ice && T > PV(T_FRZ);
    const float dq_m = (melting ? dLdt : 0.0f) / rho;
    const float dn_m = (melting ? dNdt : 0.0f) / rho;
    dq_rai = dq_rai + dq_m;
    dn_rai = dn_rai + dn_m;
    dq_ice = dq_ice - dq_m;
    dn_ice = dn_ice - dn_m;
    dq_rim = dq_rim - dq_m * s.F;
    db_rim = db_rim - (has_rim ? dq_m * s.F / rr_safe : 0.0f);
  }

  // F23 deposition nucleation and the F23-capped Bigg immersion freezing
  const float q_liq = q_lcl + q_rai;
  const float q_sat_ice = e_si / (rho * PV(R_V) * T);
  const float q_vap = maxf(q_tot - q_liq - q_ice, 0.0f);
  const float inpc_per_kg = expf(inp_mean(P, T) + 0.0f) / rho;
  {
    const float S_i = q_vap / q_sat_ice - 1.0f;
    const bool cond = T < PV(F23_T_THRESH) && S_i > PV(S_I_THRESH);
    float dn = maxf(inpc_per_kg - n_ice, 0.0f) * PV(INV_TAU_ACT);
    dn = cond ? dn : 0.0f;
    const float q_excess = maxf(q_vap - q_sat_ice, 0.0f);
    const float dq = minf(PV(M_NUC) * dn, q_excess * PV(INV_2TAU_ACT));
    dn_ice = dn_ice + dn;
    dq_ice = dq_ice + dq;
  }
  {
    const float n = N_lcl / rho;
    const CloudPDF cp = pdf_cloud(P, q_lcl, rho, N_lcl);
    const bool ok = isfinite(cp.lam_c) && cp.lam_c > 0.0f;
    const float lam_safe = ok ? cp.lam_c : 1.0f;
    const float J = PV(HET_B) * expf(PV(HET_A) * (PV(T_FRZ) - T));
    const float M3 = ok ? n * tpow(lam_safe, PV(GGM_E3)) * PV(GGM_R3) : 0.0f;
    const float M6 = ok ? n * tpow(lam_safe, PV(GGM_E6)) * PV(GGM_R6) : 0.0f;
    const bool cond = n > en && q_lcl > em && T < PV(T_FRZ_M4);
    const float cld_n = cond ? J * PV(V1) * M3 : 0.0f;
    const float cld_q = cond ? J * PV(RHO_W) * PV(V1SQ) * M6 : 0.0f;
    float cap = maxf(inpc_per_kg - n_ice, 0.0f) * PV(INV_TAU_ACT);
    cap = T >= PV(F23_T_FREEZE) ? 0.0f : cap;
    const float dn_imm = minf(cld_n, cap);
    const bool freezing = cld_n > 0.0f;
    const float dq_imm = freezing ? cld_q * dn_imm / (freezing ? cld_n : 1.0f) : 0.0f;
    dq_lcl = dq_lcl - dq_imm;
    dn_lcl = dn_lcl - dn_imm;
    dq_ice = dq_ice + dq_imm;
    dn_ice = dn_ice + dn_imm;
    dq_rim = dq_rim + dq_imm;
    db_rim = db_rim + dq_imm * PV(INV_RHO_I);
  }

  // ice sublimation / deposition relaxation
  {
    const bool some_ice = q_ice > em;
    const float n_per_q = some_ice ? n_ice / (some_ice ? q_ice : 1.0f) : 0.0f;
    const float Ls = PV(LH_S0) + PV(DCP_VI) * (T - PV(T_0));
    const float cp_air = PV(CP_D) + PV(CPVD) * q_tot + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
    const float dqdT = q_sat_ice * (Ls / (PV(R_V) * (T * T)) - 1.0f / T);
    const float ts = PV(TAU_SD) * (1.0f + (Ls / cp_air) * dqdT);
    const float sat = q_vap - q_sat_ice;
    float dq_dep = sat < 0.0f ? -minf(-sat, maxf(q_ice, 0.0f)) / ts : sat / ts;
    dq_dep = T > PV(T_FRZ) ? minf(dq_dep, 0.0f) : dq_dep;
    const float dn_dep = dq_dep < 0.0f ? n_per_q * dq_dep : 0.0f;
    dq_ice = dq_ice + dq_dep;
    dn_ice = dn_ice + dn_dep;
    const float dq_sub = minf(dq_dep, 0.0f);
    dq_rim = dq_rim + dq_sub * s.F;
    db_rim = db_rim + (has_rim ? dq_sub * s.F / rr_safe : 0.0f);
  }

  // ice number adjustment (mass limits)
  {
    const float n_tgt =
        q_ice < em ? 0.0f : clampf(n_ice, q_ice * PV(INV_XI_MAX), q_ice * PV(INV_XI_MIN));
    dn_ice = dn_ice + (n_tgt - n_ice) * PV(INV_TAU_NI);
  }

  // Bigg rain freezing (fully rimed)
  {
    const float n = N_rai / rho;
    const float Dr_mean = pdf_rain<true, kIceRainPDF>(P, q_rai, rho, N_rai).Dr_mean;
    const bool pos = Dr_mean > 0.0f;
    const float Dm = pos ? Dr_mean : 1.0f;
    const float J = PV(HET_B) * expf(PV(HET_A) * (PV(T_FRZ) - T));
    const float M3 = pos ? n * 6.0f * (Dm * Dm * Dm) : 0.0f;
    const float M6 = pos ? n * 720.0f * powf(Dm, 6.0f) : 0.0f;
    const bool cond = n > en && q_rai > em && T < PV(T_FRZ_M4);
    const float rf_n = cond ? J * PV(V1) * M3 : 0.0f;
    const float rf_q = cond ? J * PV(IR_RHO_W) * PV(V1SQ) * M6 : 0.0f;
    dq_rai = dq_rai - rf_q;
    dn_rai = dn_rai - rf_n;
    dq_ice = dq_ice + rf_q;
    dn_ice = dn_ice + rf_n;
    dq_rim = dq_rim + rf_q;
    db_rim = db_rim + rf_q * PV(INV_RHO_I);
  }

  o.dq_lcl = dq_lcl;
  o.dn_lcl = dn_lcl;
  o.dq_rai = dq_rai;
  o.dn_rai = dn_rai;
  o.dq_ice = dq_ice;
  o.dn_ice = dn_ice;
  o.dq_rim = dq_rim;
  o.db_rim = db_rim;

  // ---- 8. fall speeds and fluxes (models/column.py) --------------------
  RainSpeeds rs;
  if (limited)
    rs = chen ? rain_fall_speeds<true, true>(P, x.rho, x.q_rai, x.n_rai)
              : rain_fall_speeds<true, false>(P, x.rho, x.q_rai, x.n_rai);
  else
    rs = chen ? rain_fall_speeds<false, true>(P, x.rho, x.q_rai, x.n_rai)
              : rain_fall_speeds<false, false>(P, x.rho, x.q_rai, x.n_rai);
  const bool v_empty = s.N < PV(EPS_MACH) || s.L < PV(EPS_MACH);
  const float vt_n_ice = v_empty ? 0.0f : acc_vn / maxf(s.N, tiny);
  const float vt_m_ice = v_empty ? 0.0f : acc_vm / maxf(s.L, tiny);
  o.F[0] = x.rho * rs.vt_m * x.q_rai;
  o.F[1] = x.rho * rs.vt_n * x.n_rai;
  o.F[2] = x.rho * vt_m_ice * x.q_ice;
  o.F[3] = x.rho * vt_n_ice * x.n_ice;
  o.F[4] = x.rho * vt_m_ice * x.q_rim;
  o.F[5] = x.rho * vt_m_ice * x.b_rim;

  // ---- 9. latent heating, unclamped state ------------------------------
  const float Lf_T = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const float cp = PV(CP_D) + PV(CPVD) * x.q_tot + PV(CPLV) * (x.q_lcl + x.q_rai) +
                   PV(CPIV) * x.q_ice;
  o.T_new = T + dt * (w.Lv * (dq_lcl + dq_rai + dq_ice) + Lf_T * dq_ice) / cp;
  return o;
}

struct Fields {
  const float* in[kFields];
  float* out[kFields];
  const float* guess;  // nullptr: cold start
  float* loglam;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
column_p3_step_kernel(Fields f, const float* __restrict__ P, int ncol, int nlev,
                      int block_cols, float dt, float dz, int limited, int chen) {
  __shared__ float flux[kFluxes][kThreads];
  const int t = threadIdx.x;
  const int cols_per_pass = kThreads / nlev;
  const int lc = t / nlev;
  const int k = t - lc * nlev;
  const int64_t col_base = (int64_t)blockIdx.x * block_cols;

  for (int c0 = 0; c0 < block_cols; c0 += cols_per_pass) {
    const int64_t col = col_base + c0 + lc;
    const bool active = lc < cols_per_pass && c0 + lc < block_cols && col < ncol;
    const int64_t idx = col * nlev + k;
    CellIn x;
    CellOut o;
    if (active) {
      x.rho = f.in[0][idx];
      x.T = f.in[1][idx];
      x.q_tot = f.in[2][idx];
      x.q_lcl = f.in[3][idx];
      x.n_lcl = f.in[4][idx];
      x.q_rai = f.in[5][idx];
      x.n_rai = f.in[6][idx];
      x.q_ice = f.in[7][idx];
      x.n_ice = f.in[8][idx];
      x.q_rim = f.in[9][idx];
      x.b_rim = f.in[10][idx];
      const bool warm_start = f.guess != nullptr;
      o = cell_step<N>(P, x, warm_start, warm_start ? f.guess[idx] : 0.0f, dt, limited,
                       chen);
#pragma unroll
      for (int i = 0; i < kFluxes; ++i) flux[i][t] = o.F[i];
    }
    __syncthreads();
    if (active) {
      const bool top = k == nlev - 1;
      const float rho_dz = x.rho * dz;
      float sed[kFluxes];
#pragma unroll
      for (int i = 0; i < kFluxes; ++i) sed[i] = ((top ? 0.0f : flux[i][t + 1]) - o.F[i]) / rho_dz;
      // sed: q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
      f.out[0][idx] = x.rho;
      f.out[1][idx] = o.T_new;
      f.out[2][idx] = maxf(x.q_tot + dt * (sed[0] + sed[2]), 0.0f);
      f.out[3][idx] = maxf(x.q_lcl + dt * o.dq_lcl, 0.0f);
      f.out[4][idx] = maxf(x.n_lcl + dt * o.dn_lcl, 0.0f);
      f.out[5][idx] = maxf(x.q_rai + dt * (o.dq_rai + sed[0]), 0.0f);
      f.out[6][idx] = maxf(x.n_rai + dt * (o.dn_rai + sed[1]), 0.0f);
      const float q_ice_new = maxf(x.q_ice + dt * (o.dq_ice + sed[2]), 0.0f);
      const float q_rim_new = maxf(x.q_rim + dt * (o.dq_rim + sed[4]), 0.0f);
      f.out[7][idx] = q_ice_new;
      f.out[8][idx] = maxf(x.n_ice + dt * (o.dn_ice + sed[3]), 0.0f);
      f.out[9][idx] = minf(q_rim_new, q_ice_new);
      f.out[10][idx] = maxf(x.b_rim + dt * (o.db_rim + sed[5]), 0.0f);
      f.loglam[idx] = o.loglam;
    }
    __syncthreads();
  }
}

template <int N>
int launch_order(const Fields& f, const float* params, int ncol, int nlev, int block_cols,
                 float dt, float dz, int limited, int chen, cudaStream_t s) {
  const int grid = (ncol + block_cols - 1) / block_cols;
  column_p3_step_kernel<N><<<grid, kThreads, 0, s>>>(f, params, ncol, nlev, block_cols,
                                                     dt, dz, limited, chen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column_p3_threads_per_block() { return kThreads; }

int column_p3_num_params() { return N_PARAMS; }

// Length of the node/weight tables behind the scalar parameters for a
// quadrature order (0 for an order without a compiled variant).
int column_p3_table_len(int order) {
  switch (order) {
    case 4: return Orders<4>::LEN;
    case 8: return Orders<8>::LEN;
    case 16: return Orders<16>::LEN;
    default: return 0;
  }
}

// K5: eleven (ncol, nlev) inputs and outputs in ColumnStateP3 order, an
// optional (ncol, nlev) warm-start guess (null for a cold start) and the
// (ncol, nlev) log lambda output.
int column_p3_step(const float* const* in, float* const* out, const float* guess,
                   float* loglam, const float* params, int order, int ncol, int nlev,
                   int block_cols, float dt, float dz, int limited, int chen, int device,
                   void* stream) {
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = in[i];
    f.out[i] = out[i];
  }
  f.guess = guess;
  f.loglam = loglam;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 4: return launch_order<4>(f, params, ncol, nlev, block_cols, dt, dz, limited, chen, s);
    case 8: return launch_order<8>(f, params, ncol, nlev, block_cols, dt, dz, limited, chen, s);
    case 16: return launch_order<16>(f, params, ncol, nlev, block_cols, dt, dz, limited, chen, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
