// 2-moment warm rain + P3 ice column step: one explicit Euler step of
// models/column.py:step_column_p3 over (ncol, nlev) f32 columns of the
// eleven prognostic fields (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
// q_ice, n_ice, q_rim, b_rim), with an optional warm-start log lambda, to
// the eleven new fields and the solved log lambda.
//
// Replaces the Pallas TPU kernel cloudmicrophysics_tpu/kernels/column_p3.py:
// step_column_p3_pallas, which re-runs the XLA step on a tile.
//
// What bounds it on an H100: not HBM (48 B read and 48 B written per cell)
// but the instruction stream. Per cell: some ten shape-solve residuals of six
// fixed-trip incomplete gammas each, four inverse incomplete gammas, and for
// each of the 4 x N ice quadrature nodes a dozen exp/log/pow calls, 2 x N_L
// liquid pairs and the 4-6 fresh inner nodes of the self-collection
// triangle (about 350 ice-particle evaluations per cell at N = 16). The
// design spreads that work over enough threads to keep the card's issue
// slots busy, in three kernels on the caller's stream, joined by a
// structure-of-arrays scratch record of kScratch floats per cell (PERF.md
// gives each kernel's time, instructions and share of the issue rate):
//
//   K5a (column_p3_solve_kernel): a thread per cell over the flat
//     ncol * nlev grid: the raw-state shape solve (fixed 8-iteration
//     branchless Brent over the segment-summed log mass moment, warm-started
//     when a guess is given; log lambda out), the sanitized state of
//     p3_step_aux, mu, lambda, log N0, the five ice integration bounds and
//     the cloud window of the collisions (4 Halley steps of the inverse
//     incomplete gamma each). Its time goes to the latency of dependent
//     chains of IEEE divisions (the incomplete gammas' recurrences), so it
//     runs many warps (kSolveMinBlocks blocks per SM, spilling a little),
//     evaluates only the branch of an incomplete gamma that it keeps, runs
//     a residual's six incomplete gammas two at a time per branch (two
//     chains in flight, the lanes of a warp on one branch's code),
//     evaluates a residual's log gammas once per distinct segment shape, and
//     the cloud window's parameter-only inverse gammas once per block. It
//     also computes the node pass's per-cell factors (fall-speed and rain
//     coefficients, PSD windows, freezing factors), a thread per cell rather
//     than a warp per cell.
//   K5b (column_p3_nodes_kernel<N>): G = min(32, 4N) lanes per cell, each
//     owning 4N / G ice nodes; the cell's liquid node factors are computed
//     once into shared memory and read by broadcast. Each lane evaluates its
//     nodes (Chen 2022 + aspect-ratio velocity, PSD weight, liquid x ice
//     collisions with the Musil freezing/shedding split and wet growth,
//     melt, fall-speed moments, the within-segment self-collection triangle)
//     and writes every per-node addend to shared memory. Then every node-axis
//     sum runs serially, one node at a time in node order, one lane per sum:
//     the ten collision sums, melt and the two fall-speed sums over all
//     nodes; each segment's six moments, from which the prefix moments of
//     the cross-segment blocks follow; then the cross-segment addends and
//     their per-segment sums, and the aggregation rate.
//   K5c (column_p3_epilogue_kernel<LIMITED, CHEN>): a thread per (column,
//     level), blocks of whole columns: F23 deposition nucleation, F23-capped Bigg immersion
//     freezing, sublimation/deposition, ice number adjustment, Bigg rain
//     freezing, the SB2006 warm rates (warm2m.cuh, shared with column2m.cu),
//     rain and ice sedimentation (six fluxes of level k + 1 through shared
//     memory), latent heating, the clamp and q_rim <= q_ice.
//
// Rounding: it is built with --fmad=false and without fast math, and each
// expression follows the eager PyTorch step's operation order as PyTorch's
// CUDA kernels evaluate it (see warm2m.cuh), with the parameters folded on
// the host as the eager code folds its Python floats. Each per-node value is
// computed by one lane with the code and operation order of a serial pass,
// and every node-axis sum of the eager step runs one node at a time in node
// order (utils/quadrature.py:sum_nodes), as K5b's serial sums do: no tree
// reduction and no atomics. Where an operation rounded differently, discrete
// arms could flip on a last-bit difference: the wet-growth test
// dM_col > dM_frz (ops/p3_processes.py), the regime select at the segment
// thresholds, and the Brent accept test.
//
// Infinities: D_gr and D_cr are +inf for unrimed ice, collapsed segments
// carry zero weight and -inf log moments (excluded from the logsumexp), and
// cells without ice run the node pass on the placeholder state of
// p3_step_aux and are masked, as in the eager step.
//
// Operation counts: built with -DK5_PROBE, every K5_COUNT(region) adds one to
// a per-thread counter of that region and, once per warp, to a per-warp one
// (an optional second argument is the unroll factor of the loop it sits in);
// chip_smoke.py multiplies the counts by the SASS instructions that the line
// table of the plain build puts in each region (kernels/opcount.py). Without
// K5_PROBE the counters compile to nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column_p3_params.h"
#include "warm2m.cuh"

// Counted regions; the K5_COUNT sites that name them are listed in
// chip_smoke.py's operation count.
enum ProbeRegion {
  R_SOLVE, R_BRENT_IT, R_LOGLDIVN, R_GI_SERIES, R_GI_SERIES_IT, R_GI_CF,
  R_GI_CF_IT, R_GI_SERIES2, R_GI_SERIES2_IT, R_GI_CF2, R_GI_CF2_IT,
  R_GI_SERIES2_DUP, R_GI_CF2_DUP, R_LGAMMA,
  R_INV, R_INV_IT, R_STATE,
  R_NODE_LANE, R_LIQ, R_NODE, R_TRI_IT, R_TASK, R_SUM_IT, R_PREFIX, R_CROSS,
  R_CROSS_SUM, R_AGG,
  R_EPI, R_EPI_OUT,
  R_COUNT
};

#ifdef K5_PROBE
__device__ unsigned int* g_probe;
__device__ long long g_probe_stride;
// rows r: the thread's executions of region r; rows R_COUNT + r: the warp's,
// kept by its lowest active lane
__device__ __forceinline__ void k5_count(int r, int unroll = 1) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  g_probe[r * g_probe_stride + t] += 1u;
  if ((int)(threadIdx.x & 31) == __ffs(__activemask()) - 1)
    g_probe[(R_COUNT + r) * g_probe_stride + t] += 1u;
}
#define K5_COUNT(...) k5_count(__VA_ARGS__)
#else
#define K5_COUNT(...)
#endif

namespace {

using namespace warm2m;

constexpr int kFields = 11;
constexpr int kFluxes = 6;
constexpr int kSegments = 4;
// threads per block and blocks per SM each kernel is compiled for
constexpr int kSolveThreads = 128, kSolveMinBlocks = 16;
constexpr int kNodeThreads = 128, kNodeMinBlocks = 4;
constexpr int kEpiThreads = 256, kEpiMinBlocks = 2;
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

// The scratch record between the kernels, one (ncol * nlev) row per field:
// K5a's sanitized state, PSD, bounds and per-cell factors of the node pass,
// then K5b's node-pass sums (in the order of the node addends A_QCFRZ ..
// A_VM, then the aggregation rate).
enum Scratch {
  S_L, S_N, S_F, S_RHO_RIM, S_RHO_G, S_D_GR, S_D_CR,
  S_MU, S_LAM, S_LOG_N0, S_B0, S_B1, S_B2, S_B3, S_B4, S_C_LO, S_C_HI,
  // the node pass's per-cell factors: ice fall-speed coefficients, rain
  // window (validity, bounds, N0, mean diameter), cloud PSD, the ice
  // container's Chen 2022 rain coefficients, freezing-limit factors
  S_VC_AS0, S_VC_AS1, S_VC_BS, S_VC_AL0, S_VC_AL1,
  S_RAIN_OK, S_R_LO, S_R_HI, S_R_N0, S_R_DM, S_CP_LOGN0, S_CP_LAM,
  S_CR_A0, S_CR_A1, S_CR_A2, S_CR_B0, S_CR_B1, S_CR_B2,
  S_INV_2TC, S_FRZ_NUM, S_FRZ_DEN,
  S_QCFRZ, S_QCSHD, S_NCCOL, S_QRFRZ, S_QRSHD, S_NRCOL, S_INT_M, S_BCCOL,
  S_BRCOL, S_INT_WET, S_MELT, S_VN, S_VM, S_AGG,
  kScratch
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

// utils/special.py:_gamma_inc_core at float32: the series (20 terms) when
// x < a + 1, else the Lentz continued fraction (20 iterations), no early exit.
// The plain step evaluates both and selects one; only the selected one is
// evaluated here, with the same operations, so the result is the same.
__device__ __forceinline__ float gi_series(const float* __restrict__ P, float a, float x,
                                           float factor) {
  K5_COUNT(R_GI_SERIES);
  const float a_safe = maxf(a, PV(TINY));
  float term = rdiv(1.0f, a_safe);
  float sum_p = term;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    K5_COUNT(R_GI_SERIES_IT, 4);
    term = term * x / (a_safe + (float)k);
    sum_p = sum_p + term;
  }
  return clampf(factor * sum_p, 0.0f, 1.0f);
}

__device__ __forceinline__ float gi_cf(const float* __restrict__ P, float a, float x,
                                       float factor) {
  K5_COUNT(R_GI_CF);
  const float tiny = PV(GI_TINY);
  const float b1 = x + 1.0f - a;
  float c = b1 + PV(GI_BIG);
  float d = rdiv(1.0f, fabsf(b1) < tiny ? tiny : b1);
  float h = d;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    K5_COUNT(R_GI_CF_IT, 4);
    const float ak = (float)(-k) * ((float)k - a);
    const float bk = x + (float)(2 * k) + 1.0f - a;
    const float d_tmp = bk + ak * d;
    d = fabsf(d_tmp) < tiny ? tiny : d_tmp;
    const float c_tmp = bk + ak / c;
    c = fabsf(c_tmp) < tiny ? tiny : c_tmp;
    d = rdiv(1.0f, d);
    h = h * (c * d);
  }
  return clampf(factor * h, 0.0f, 1.0f);
}

// _gamma_inc_core's special arguments, after its branch
__device__ __forceinline__ PQ gi_finish(PQ r, float a, float x) {
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

__device__ __forceinline__ PQ gamma_inc_core(const float* __restrict__ P, float a,
                                             float x, float lga) {
  const bool use_series = x < a + 1.0f;
  const float factor = expf(a * logf(maxf(x, PV(TINY))) - x - lga);
  PQ r;
  if (use_series) {
    const float P_series = gi_series(P, a, x, factor);
    r.p = P_series;
    r.q = 1.0f - P_series;
  } else {
    const float Q_cf = gi_cf(P, a, x, factor);
    r.p = 1.0f - Q_cf;
    r.q = Q_cf;
  }
  return gi_finish(r, a, x);
}

// gi_series and gi_cf on two arguments at once: each chain is the single
// evaluation's operations; the two are independent, so a thread keeps two
// dependent chains of divisions in flight
__device__ __forceinline__ void gi_series2(const float* __restrict__ P, float a1, float x1,
                                           float f1, float a2, float x2, float f2,
                                           float& r1, float& r2) {
  K5_COUNT(R_GI_SERIES2);
  const float a_safe1 = maxf(a1, PV(TINY)), a_safe2 = maxf(a2, PV(TINY));
  float term1 = rdiv(1.0f, a_safe1), term2 = rdiv(1.0f, a_safe2);
  float sum1 = term1, sum2 = term2;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    K5_COUNT(R_GI_SERIES2_IT, 4);
    term1 = term1 * x1 / (a_safe1 + (float)k);
    term2 = term2 * x2 / (a_safe2 + (float)k);
    sum1 = sum1 + term1;
    sum2 = sum2 + term2;
  }
  r1 = clampf(f1 * sum1, 0.0f, 1.0f);
  r2 = clampf(f2 * sum2, 0.0f, 1.0f);
}

__device__ __forceinline__ void gi_cf2(const float* __restrict__ P, float a1, float x1,
                                       float f1, float a2, float x2, float f2, float& r1,
                                       float& r2) {
  K5_COUNT(R_GI_CF2);
  const float tiny = PV(GI_TINY);
  const float b1_1 = x1 + 1.0f - a1, b1_2 = x2 + 1.0f - a2;
  float c1 = b1_1 + PV(GI_BIG), c2 = b1_2 + PV(GI_BIG);
  float d1 = rdiv(1.0f, fabsf(b1_1) < tiny ? tiny : b1_1);
  float d2 = rdiv(1.0f, fabsf(b1_2) < tiny ? tiny : b1_2);
  float h1 = d1, h2 = d2;
#pragma unroll 4
  for (int k = 1; k <= 20; ++k) {
    K5_COUNT(R_GI_CF2_IT, 4);
    const float ak1 = (float)(-k) * ((float)k - a1);
    const float ak2 = (float)(-k) * ((float)k - a2);
    const float bk1 = x1 + (float)(2 * k) + 1.0f - a1;
    const float bk2 = x2 + (float)(2 * k) + 1.0f - a2;
    const float d_tmp1 = bk1 + ak1 * d1;
    const float d_tmp2 = bk2 + ak2 * d2;
    d1 = fabsf(d_tmp1) < tiny ? tiny : d_tmp1;
    d2 = fabsf(d_tmp2) < tiny ? tiny : d_tmp2;
    const float c_tmp1 = bk1 + ak1 / c1;
    const float c_tmp2 = bk2 + ak2 / c2;
    c1 = fabsf(c_tmp1) < tiny ? tiny : c_tmp1;
    c2 = fabsf(c_tmp2) < tiny ? tiny : c_tmp2;
    d1 = rdiv(1.0f, d1);
    d2 = rdiv(1.0f, d2);
    h1 = h1 * (c1 * d1);
    h2 = h2 * (c2 * d2);
  }
  r1 = clampf(f1 * h1, 0.0f, 1.0f);
  r2 = clampf(f2 * h2, 0.0f, 1.0f);
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
  K5_COUNT(R_INV);
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
    K5_COUNT(R_INV_IT);
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
__device__ __forceinline__ P3S state_from_prognostic(const float* __restrict__ P,
                                                     float L, float N, float L_rim,
                                                     float B_rim) {
  K5_COUNT(R_STATE);
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
  float v, m, area, log_D;
};

// ops/p3.py:ice_particle_terminal_velocity (with phi_i, ice_mass, ice_area)
__device__ __forceinline__ IceParticle ice_particle(const float* __restrict__ P,
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
  o.log_D = log_D;
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

// logLdivN's two log gammas of a segment's shape z: the Lanczos one of the
// incomplete gammas and lgammaf of the log moment
__device__ __forceinline__ void seg_lgamma(const float* __restrict__ P, float z, float& lgz,
                                           float& lgf) {
  K5_COUNT(R_LGAMMA);
  lgz = lgamma_pos(P, z);
  lgf = lgammaf(z);
}

// v[c] for a run-time c, without an indexed (local memory) array
template <int n>
__device__ __forceinline__ float pick(const float (&v)[n], int c) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < n; ++i) r = c == i ? v[i] : r;
  return r;
}

template <int n>
__device__ __forceinline__ void put(float (&v)[n], int c, float x) {
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = c == i ? x : v[i];
}

// ops/p3.py:logLdivN: segment-summed log mass moment minus log number
// moment; the logsumexp adds the segments in order. Its six incomplete
// gammas (the lower bounds of segments 1-3, calls 0-2, and the upper bounds
// of segments 0-2, calls 3-5) are independent: each thread runs those of
// its series branch two at a time, then those of its continued fraction,
// so that a warp's lanes run one branch's code together and each lane
// has two chains in flight (an odd count repeats a call in the second
// chain and keeps one result).
__device__ __noinline__ float logLdivN(const float* __restrict__ P, const P3S s,
                                       float ll) {
  K5_COUNT(R_LOGLDIVN);
  const float mu = get_mu(P, ll);
  const float e = expf(ll);
  const float inf = f_inf();
  const float bnds[5] = {0.0f, minf(maxf(s.D_th, 0.0f), inf),
                         minf(maxf(s.D_gr, 0.0f), inf),
                         minf(maxf(s.D_cr, 0.0f), inf), inf};
  float z[kSegments], lgz[kSegments], lgf[kSegments];
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    const MassCoeffs mc = mass_coeffs(P, s, (bnds[i] + bnds[i + 1]) * 0.5f);
    z[i] = mc.b + 0.0f + mu + 1.0f;
  }
  // the segments' log gammas, each evaluated once per distinct shape (the
  // regimes give two: z0 = z2 and z1 = z3 for rimed ice, z1 = z2 = z3 for
  // unrimed): an equal float argument gives the equal result
  seg_lgamma(P, z[0], lgz[0], lgf[0]);
  if (z[1] == z[0]) {
    lgz[1] = lgz[0], lgf[1] = lgf[0];
  } else {
    seg_lgamma(P, z[1], lgz[1], lgf[1]);
  }
  if (z[2] == z[0]) {
    lgz[2] = lgz[0], lgf[2] = lgf[0];
  } else if (z[2] == z[1]) {
    lgz[2] = lgz[1], lgf[2] = lgf[1];
  } else {
    seg_lgamma(P, z[2], lgz[2], lgf[2]);
  }
  if (z[3] == z[0]) {
    lgz[3] = lgz[0], lgf[3] = lgf[0];
  } else if (z[3] == z[1]) {
    lgz[3] = lgz[1], lgf[3] = lgf[1];
  } else if (z[3] == z[2]) {
    lgz[3] = lgz[2], lgf[3] = lgf[2];
  } else {
    seg_lgamma(P, z[3], lgz[3], lgf[3]);
  }
  // call c: shape z[seg(c)], seg(c) = c + 1 (c < 3) or c - 3; argument
  // xb[c % 3] = bnds[c % 3 + 1] * e; gf[c] the prefactor of _gamma_inc_core
  const float xb[3] = {bnds[1] * e, bnds[2] * e, bnds[3] * e};
  float gf[6], v[6];
  unsigned series = 0u;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int sg = c < 3 ? c + 1 : c - 3;
    const float a = z[sg], x = xb[c % 3];
    gf[c] = expf(a * logf(maxf(x, PV(TINY))) - x - lgz[sg]);
    v[c] = 0.0f;
    if (x < a + 1.0f) series |= 1u << c;
  }
  // v[c]: P of the series, or Q of the continued fraction
  unsigned todo = series;
#pragma unroll 1
  while (todo) {
    const int c1 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int c2 = todo ? __ffs(todo) - 1 : c1;
    if (c2 == c1) { K5_COUNT(R_GI_SERIES2_DUP); }
    todo &= todo - 1;
    const float a1 = pick(z, c1 < 3 ? c1 + 1 : c1 - 3), a2 = pick(z, c2 < 3 ? c2 + 1 : c2 - 3);
    float r1, r2;
    gi_series2(P, a1, pick(xb, c1 % 3), pick(gf, c1), a2, pick(xb, c2 % 3), pick(gf, c2),
               r1, r2);
    put(v, c1, r1);
    put(v, c2, r2);
  }
  todo = ~series & 0x3fu;
#pragma unroll 1
  while (todo) {
    const int c1 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int c2 = todo ? __ffs(todo) - 1 : c1;
    if (c2 == c1) { K5_COUNT(R_GI_CF2_DUP); }
    todo &= todo - 1;
    const float a1 = pick(z, c1 < 3 ? c1 + 1 : c1 - 3), a2 = pick(z, c2 < 3 ? c2 + 1 : c2 - 3);
    float r1, r2;
    gi_cf2(P, a1, pick(xb, c1 % 3), pick(gf, c1), a2, pick(xb, c2 % 3), pick(gf, c2), r1,
           r2);
    put(v, c1, r1);
    put(v, c2, r2);
  }
  PQ g[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const bool ser = (series >> c) & 1u;
    g[c].p = ser ? v[c] : 1.0f - v[c];
    g[c].q = ser ? 1.0f - v[c] : v[c];
    g[c] = gi_finish(g[c], z[c < 3 ? c + 1 : c - 3], xb[c % 3]);
  }
  float m[kSegments];
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    const float lo = bnds[i], hi = bnds[i + 1];
    PQ g1, g2;
    float x2;
    if (i == 0) {
      g1.p = 0.0f;
      g1.q = 1.0f;
    } else {
      g1 = g[i - 1];
    }
    if (i == kSegments - 1) {
      g2.p = 1.0f;
      g2.q = 0.0f;
      x2 = inf;
    } else {
      x2 = hi * e;
      g2 = g[i + 3];
    }
    float dq = x2 < z[i] + 1.0f ? g2.p - g1.p : g1.q - g2.q;
    dq = maxf(dq, PV(EPS_MACH));
    float out = -z[i] * ll + lgf[i] + logf(dq) + 0.0f;
    out = lo < hi ? out : -inf;
    out = out + logf(maxf(mass_coeffs(P, s, (lo + hi) * 0.5f).a, PV(TINY)));
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
__device__ __forceinline__ float shape_solve(const float* __restrict__ P, const P3S& s,
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
    K5_COUNT(R_BRENT_IT);
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
// The step's three kernels
// ---------------------------------------------------------------------------

struct Fields {
  const float* in[kFields];
  float* out[kFields];
  const float* guess;  // nullptr: cold start
  float* loglam;
};

// ---- K5a: shape solve, sanitized state, bounds, cloud window -------------

__global__ void __launch_bounds__(kSolveThreads, kSolveMinBlocks)
column_p3_solve_kernel(Fields f, const float* __restrict__ P, float* __restrict__ scr,
                       int64_t ncells) {
  // The cloud window's two inverse incomplete gammas take only parameters:
  // the block's first thread evaluates them before its own cell, and every
  // thread reads them after a barrier that it reaches after its shape solve.
  __shared__ float cloud_x[2];
  if (threadIdx.x == 0) {
    cloud_x[0] = gamma_inc_inv4(P, PV(CB_A), PV(CB_P_LO), PV(CB_Q_LO));
    cloud_x[1] = gamma_inc_inv4(P, PV(CB_A), PV(CB_P_HI), PV(CB_Q_HI));
  }
  K5_COUNT(R_SOLVE);
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = cell < ncells;
  // a thread past the last cell repeats it and stores nothing, so that every
  // thread of the block reaches the barrier
  const int64_t i = active ? cell : ncells - 1;
  const float em = PV(EM), en = PV(EN), tiny = PV(TINY);
  const float x_rho = f.in[0][i];
  const float x_q_ice = f.in[7][i], x_n_ice = f.in[8][i];
  const float x_q_rim = f.in[9][i], x_b_rim = f.in[10][i];

  // shape solve on the raw state (models/column.py)
  const P3S raw = state_from_prognostic(P, x_q_ice * x_rho, x_n_ice * x_rho,
                                        x_q_rim * x_rho, x_b_rim * x_rho);
  const bool warm_start = f.guess != nullptr;
  const float loglam = shape_solve(P, raw, warm_start, warm_start ? f.guess[i] : 0.0f);

  // p3_step_aux: the sanitized state and its bounds
  const float q_ice = maxf(x_q_ice, 0.0f);
  const float n_ice = maxf(x_n_ice, 0.0f);
  const float L_ice = q_ice * x_rho, N_ice = n_ice * x_rho;
  const float L_rim = maxf(x_q_rim, 0.0f) * x_rho, B_rim = maxf(x_b_rim, 0.0f) * x_rho;
  const bool has_ice = q_ice > em && n_ice > en;
  const P3S s = state_from_prognostic(P, has_ice ? L_ice : 1e-6f, has_ice ? N_ice : 1e3f,
                                      has_ice ? L_rim : 0.0f, has_ice ? B_rim : 0.0f);
  const float ll = (has_ice && isfinite(loglam)) ? loglam : 8.0f;
  const float mu = get_mu(P, ll);
  const float lam = expf(ll);
  const float k1 = mu + 0.0f + 1.0f;
  const float D_min = gamma_inc_inv4(P, k1, PV(IB_P_LO), PV(IB_Q_LO)) / lam;
  const float D_max = gamma_inc_inv4(P, k1, PV(IB_P_HI), PV(IB_Q_HI)) / lam;
  const float log_N0 = logf(maxf(s.N, tiny)) - loggamma_moment(mu, ll);

  // the cloud PSD's tail-quantile window of the collision integral
  const float rho = maxf(x_rho, 0.0f);
  const float L_lcl = maxf(f.in[3][i], 0.0f) * rho, N_lcl = maxf(f.in[4][i], 0.0f) * rho;
  const CloudPDF cp = pdf_cloud(P, L_lcl / rho, rho, N_lcl);
  const bool bad = isinf(cp.lam_c) || cp.lam_c <= 0.0f;
  const float lam_safe = bad ? 1.0f : cp.lam_c;
  __syncthreads();
  const float c_lo = tpow(cloud_x[0] / lam_safe, PV(CB_INV_MU));
  const float c_hi = tpow(cloud_x[1] / lam_safe, PV(CB_INV_MU));
  if (!active) return;

  f.loglam[i] = loglam;
  float* __restrict__ o = scr + i;
  o[S_L * ncells] = s.L;
  o[S_N * ncells] = s.N;
  o[S_F * ncells] = s.F;
  o[S_RHO_RIM * ncells] = s.rho_rim;
  o[S_RHO_G * ncells] = s.rho_g;
  o[S_D_GR * ncells] = s.D_gr;
  o[S_D_CR * ncells] = s.D_cr;
  o[S_MU * ncells] = mu;
  o[S_LAM * ncells] = lam;
  o[S_LOG_N0 * ncells] = log_N0;
  o[S_B0 * ncells] = D_min;
  o[S_B1 * ncells] = minf(maxf(s.D_th, D_min), D_max);
  o[S_B2 * ncells] = minf(maxf(s.D_gr, D_min), D_max);
  o[S_B3 * ncells] = minf(maxf(s.D_cr, D_min), D_max);
  o[S_B4 * ncells] = D_max;
  o[S_C_LO * ncells] = bad ? 0.0f : c_lo;
  o[S_C_HI * ncells] = bad ? 0.0f : c_hi;
  o[S_CP_LOGN0 * ncells] = cp.logN0c;
  o[S_CP_LAM * ncells] = cp.lam_c;

  // the node pass's per-cell factors: ice fall speeds at the cell's air
  // density, the rain PSD's window, the ice container's Chen 2022 rain
  // coefficients, the freezing limit's factors
  const IceVel vc = ice_vel_coeffs(P, x_rho);
  o[S_VC_AS0 * ncells] = vc.as0;
  o[S_VC_AS1 * ncells] = vc.as1;
  o[S_VC_BS * ncells] = vc.bs;
  o[S_VC_AL0 * ncells] = vc.al0;
  o[S_VC_AL1 * ncells] = vc.al1;
  const float L_rai = maxf(f.in[5][i], 0.0f) * rho, N_rai = maxf(f.in[6][i], 0.0f) * rho;
  const RainPDF rp = pdf_rain<true, kIceRainPDF>(P, L_rai / rho, rho, N_rai);
  const float Dm_safe = rp.Dr_mean > 0.0f ? rp.Dr_mean : 1.0f;
  const bool zero = rp.Dr_mean == 0.0f;
  const float r_lo = zero ? 0.0f : -Dm_safe * PV(LOG1P_NEG_P);
  const float r_hi = zero ? 0.0f : -Dm_safe * PV(LOG1P_NEG_1MP);
  const bool rain_valid = rp.N0 > 0.0f && r_hi > r_lo;
  o[S_RAIN_OK * ncells] = rain_valid ? 1.0f : 0.0f;
  o[S_R_LO * ncells] = rain_valid ? r_lo : 1.0f;
  o[S_R_HI * ncells] = rain_valid ? r_hi : 2.0f;
  o[S_R_N0 * ncells] = rp.N0;
  o[S_R_DM * ncells] = Dm_safe;
  const ChenRain cr = chen_rain_coeffs<kIceChen>(P, rho);
  o[S_CR_A0 * ncells] = cr.a[0];
  o[S_CR_A1 * ncells] = cr.a[1];
  o[S_CR_A2 * ncells] = cr.a[2];
  o[S_CR_B0 * ncells] = cr.b[0];
  o[S_CR_B1 * ncells] = cr.b[1];
  o[S_CR_B2 * ncells] = cr.b[2];
  const float T = f.in[1][i];
  const float Lv = PV(LH_V0) + PV(DCP_VL) * (T - PV(T_0));
  const float T_c = T - PV(P3_T_FREEZE);
  const float Lf = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const float e_si = p_sat_ice(P, T);
  const float dT = PV(T_FRZ) - T;
  const float drho_v_sat = rho * (rdiv(PV(E_SI_FRZ), rho * PV(R_V) * PV(T_FRZ)) -
                                  e_si / (rho * PV(R_V) * T));
  o[S_INV_2TC * ncells] = rdiv(1e6f, 2.0f * (fabsf(T_c) > 0.0f ? T_c : -PV(EPS_MACH)));
  o[S_FRZ_DEN * ncells] = Lf - PV(CP_L) * dT;
  o[S_FRZ_NUM * ncells] = PV(K_THERM) * dT + Lv * PV(D_VAPOR) * drho_v_sat;
}

// ---- K5b: the ice node pass ----------------------------------------------

// Per-node addends K5b writes to shared memory: the ten collision sums, melt
// and the two fall-speed sums (all nodes, scratch order S_QCFRZ .. S_VM), the
// six segment moments (nw, nw r, nw r^2 and each times v), the triangle and
// cross-segment addends, and r and v for the cross-segment blocks.
enum Addend {
  A_QCFRZ, A_QCSHD, A_NCCOL, A_QRFRZ, A_QRSHD, A_NRCOL, A_INT_M, A_BCCOL, A_BRCOL,
  A_INT_WET, A_MELT, A_VN, A_VM,
  A_M0, A_TRI = A_M0 + 6, A_CROSS, A_R, A_V,
  kAddends
};
constexpr int kAllNodeSums = A_M0;  // sums over every node of the cell
// serial sums per cell: those over every node, six moments and the triangle
// per segment
constexpr int kTasks = kAllNodeSums + 6 * kSegments + kSegments;

template <int N>
struct NodePass {
  static constexpr int NN = kSegments * N;         // ice nodes of a cell
  static constexpr int G = NN < 32 ? NN : 32;      // lanes per cell
  static constexpr int PER = NN / G;               // nodes per lane
  static constexpr int CELLS = kNodeThreads / G;   // cells per block
};

template <int N>
struct NodeShared {
  float add[kAddends][kSegments * N];
  float liq[8][Orders<N>::NL];  // cloud D, v, nw, nw m; rain D, v, nw, nw m
  float seg[6][kSegments];      // each segment's six moments
  float pre[kSegments][6];      // the moments of the segments below each one
  float cross[kSegments], tri[kSegments];
};

// a[0] + a[1] + ... + a[n - 1] one term at a time from 0, as
// utils/quadrature.sum_nodes (n is a multiple of 4)
template <int n>
__device__ __forceinline__ float serial_sum(const float* a) {
  static_assert(n % 4 == 0, "unrolled by 4");
  float acc = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    K5_COUNT(R_SUM_IT, 4);
    acc = acc + a[i];
  }
  return acc;
}

template <int N>
__global__ void __launch_bounds__(kNodeThreads, kNodeMinBlocks)
column_p3_nodes_kernel(Fields f, const float* __restrict__ P, float* __restrict__ scr,
                       int64_t ncells) {
  using O = Orders<N>;
  using L = NodePass<N>;
  constexpr int NL = O::NL, G = L::G;
  __shared__ NodeShared<N> smem[L::CELLS];
  K5_COUNT(R_NODE_LANE);
  const float* __restrict__ TAB = P + N_PARAMS;
  const int lane = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int64_t cell = (int64_t)blockIdx.x * L::CELLS + slot;
  const bool active = cell < ncells;
  // a slot past the last cell repeats the last cell and stores nothing, so
  // that every lane of the warp reaches each __syncwarp
  const int64_t c = active ? cell : ncells - 1;
  NodeShared<N>& sh = smem[slot];
  const float tiny = PV(TINY);
  const float* __restrict__ rec = scr + c;

  const float T = f.in[1][c];
  P3S s;
  s.L = rec[S_L * ncells];
  s.N = rec[S_N * ncells];
  s.F = rec[S_F * ncells];
  s.rho_rim = rec[S_RHO_RIM * ncells];
  s.rho_g = rec[S_RHO_G * ncells];
  s.D_th = PV(D_TH);
  s.D_gr = rec[S_D_GR * ncells];
  s.D_cr = rec[S_D_CR * ncells];
  const float mu = rec[S_MU * ncells];
  const float lam = rec[S_LAM * ncells];
  const float log_N0 = rec[S_LOG_N0 * ncells];
  IceVel vc;
  vc.as0 = rec[S_VC_AS0 * ncells];
  vc.as1 = rec[S_VC_AS1 * ncells];
  vc.bs = rec[S_VC_BS * ncells];
  vc.al0 = rec[S_VC_AL0 * ncells];
  vc.al1 = rec[S_VC_AL1 * ncells];
  const bool rain_valid = rec[S_RAIN_OK * ncells] != 0.0f;
  const float inv_2Tc = rec[S_INV_2TC * ncells];
  const float frz_num = rec[S_FRZ_NUM * ncells], frz_denom = rec[S_FRZ_DEN * ncells];
  const float log_tiny = logf(tiny);

  // per-cell liquid node factors of the collision integral, two lanes per
  // node: lane k < 2 NL the fall speed of node k, lane 2 NL + k its PSD
  // weights (nodes k < NL: cloud node k; k >= NL: rain node k - NL)
  static_assert(4 * NL <= G, "two lanes per liquid node");
  if (lane < 4 * NL) {
    K5_COUNT(R_LIQ);
    const bool speed = lane < 2 * NL;
    const int k = speed ? lane : lane - 2 * NL;
    const bool cloud = k < NL;
    const int l = cloud ? k : k - NL;
    const float lo = rec[(cloud ? S_C_LO : S_R_LO) * ncells];
    const float hi = rec[(cloud ? S_C_HI : S_R_HI) * ncells];
    const bool valid = lo < hi;
    const float a_s = valid ? lo : 1.0f, b_s = valid ? hi : 2.0f;
    const float scale = (b_s - a_s) * 0.5f, mid = (a_s + b_s) * 0.5f;
    const float D = scale * __ldg(TAB + O::Y_LIQ + l) + mid;
    float* __restrict__ liq = &sh.liq[cloud ? 0 : 4][0];
    if (speed) {
      const float log_D = logf(D);
      liq[l] = D;
      liq[NL + l] = rec[S_CR_A0 * ncells] * expf(rec[S_CR_B0 * ncells] * log_D -
                                                  __ldg(P + P_CH_C1U + kIceChen) * D) +
                    rec[S_CR_A1 * ncells] * expf(rec[S_CR_B1 * ncells] * log_D -
                                                  __ldg(P + P_CH_C2U + kIceChen) * D) +
                    rec[S_CR_A2 * ncells] * expf(rec[S_CR_B2 * ncells] * log_D -
                                                  __ldg(P + P_CH_C3U + kIceChen) * D);
    } else {
      const float wl = __ldg(TAB + O::W_LIQ + l) * scale;
      float nw;
      if (cloud) {
        CloudPDF cp;
        cp.logN0c = rec[S_CP_LOGN0 * ncells];
        cp.lam_c = rec[S_CP_LAM * ncells];
        nw = n_cloud(P, cp, D) * (valid ? wl : 0.0f);
      } else {
        const float N0 = rec[S_R_N0 * ncells];
        const float nr = N0 * expf(-D / rec[S_R_DM * ncells]);
        nw = (N0 == 0.0f ? 0.0f : nr) * (valid ? wl : 0.0f);
      }
      liq[2 * NL + l] = nw;
      liq[3 * NL + l] = nw * (PV(RHO_W) * (D * D * D * PV(PI_F) * kSixth));
    }
  }
  __syncwarp();

  // ---- each lane's nodes: node g = p * G + lane is node j of segment sg
#pragma unroll 1
  for (int p = 0; p < L::PER; ++p) {
    K5_COUNT(R_NODE);
    const int g = p * G + lane;
    const int sg = g / N, j = g - sg * N;
    const float lo = rec[(S_B0 + sg) * ncells], hi = rec[(S_B0 + sg + 1) * ncells];
    const bool valid = lo < hi;
    const float a_s = valid ? lo : 1.0f, b_s = valid ? hi : 2.0f;
    const float scale = (b_s - a_s) * 0.5f, mid = (a_s + b_s) * 0.5f;
    const bool tail = sg == kSegments - 1;
    const int n_in = tail ? O::NT : O::NI;
    const int y_in = tail ? O::Y_TAIL : O::Y_IN;
    const int w_in = tail ? O::W_TAIL : O::W_IN;
    const float D = scale * __ldg(TAB + O::Y_ICE + j) + mid;
    const float wj = valid ? __ldg(TAB + O::W_ICE + j) * scale : 0.0f;
    const IceParticle ip = ice_particle(P, s, vc, D);
    const float v = ip.v;
    // logf(maxf(D, tiny)): the particle's logf(D) unless D < tiny
    const float n = expf(log_N0 + mu * (D < tiny ? log_tiny : ip.log_D) - lam * D);
    const float nw = n * wj;
    const float r = sqrtf(ip.area * PV(INV_PI));

    // -- liquid x ice collisions at this node
    const float k0 = PV(PI_F) * (r * r), k1 = PV(PI_F) * r;
    float dN_c = 0.0f, dM_c = 0.0f, dB_c = 0.0f, dN_r = 0.0f, dM_r = 0.0f, dB_r = 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float Dl = sh.liq[0][l];
      const float K = (PV(K2) * Dl + k1) * Dl + k0;
      const float v_rel = fabsf(v - sh.liq[1][l]);
      const float dV = K * v_rel;
      const float t1 = dV * sh.liq[2][l];
      const float t2 = dV * sh.liq[3][l];
      const float t3 = t2 / rho_rim_local(P, Dl * v_rel * inv_2Tc);
      dN_c = l == 0 ? t1 : dN_c + t1;
      dM_c = l == 0 ? t2 : dM_c + t2;
      dB_c = l == 0 ? t3 : dB_c + t3;
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float Dl = sh.liq[4][l];
      const float K = (PV(K2) * Dl + k1) * Dl + k0;
      const float v_rel = fabsf(v - sh.liq[5][l]);
      const float dV = K * v_rel;
      const float t1 = dV * sh.liq[6][l];
      const float t2 = dV * sh.liq[7][l];
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
    sh.add[A_QCFRZ][g] = nw * (dM_c * f_frz);
    sh.add[A_QCSHD][g] = nw * (dM_c * (1.0f - f_frz));
    sh.add[A_NCCOL][g] = nw * dN_c;
    sh.add[A_QRFRZ][g] = nw * (dM_r * f_frz);
    sh.add[A_QRSHD][g] = nw * (dM_r * (1.0f - f_frz));
    sh.add[A_NRCOL][g] = nw * dN_r;
    sh.add[A_INT_M][g] = nw * dM_col;
    sh.add[A_BCCOL][g] = nw * (dB_c * f_frz);
    sh.add[A_BRCOL][g] = nw * (dB_r * f_frz);
    sh.add[A_INT_WET][g] = nw * (wet * dM_col);

    // -- melt and the weighted fall speeds
    const MassCoeffs mc = mass_coeffs(P, s, D);
    sh.add[A_MELT][g] = mc.a * mc.b * powf(D, mc.b - 1.0f) * F_v * nw / D;
    sh.add[A_VN][g] = nw * v;
    sh.add[A_VM][g] = nw * v * ip.m;

    // -- self-collection: this segment's moments, r and v for the
    // cross-segment blocks
    const float nwr = nw * r, nwr2 = nwr * r;
    sh.add[A_M0][g] = nw;
    sh.add[A_M0 + 1][g] = nwr;
    sh.add[A_M0 + 2][g] = nwr2;
    sh.add[A_M0 + 3][g] = nw * v;
    sh.add[A_M0 + 4][g] = nwr * v;
    sh.add[A_M0 + 5][g] = nwr2 * v;
    sh.add[A_R][g] = r;
    sh.add[A_V][g] = v;

    // -- self-collection, within-segment triangle [a_seg, D]
    const float t_lo = lo + 0.0f;
    const bool t_valid = t_lo < D;
    const float ta = t_valid ? t_lo : 1.0f, tb = t_valid ? D : 2.0f;
    const float t_scale = (tb - ta) * 0.5f, t_mid = (ta + tb) * 0.5f;
    float acc = 0.0f;
#pragma unroll 1
    for (int i = 0; i < n_in; ++i) {
      K5_COUNT(R_TRI_IT);
      const float D2 = t_scale * __ldg(TAB + y_in + i) + t_mid;
      const float w2 = t_valid ? __ldg(TAB + w_in + i) * t_scale : 0.0f;
      const IceParticle ip2 = ice_particle(P, s, vc, D2);
      const float r2 = sqrtf(ip2.area * PV(INV_PI));
      const float K = PV(PI_F) * ((r + r2) * (r + r2));
      const float n2 = expf(log_N0 + mu * (D2 < tiny ? log_tiny : ip2.log_D) - lam * D2);
      acc = acc + K * fabsf(v - ip2.v) * n2 * w2;
    }
    sh.add[A_TRI][g] = acc * nw;
  }
  __syncwarp();

  // ---- the serial sums, one lane each
#pragma unroll 1
  for (int t = lane; t < kTasks; t += G) {
    K5_COUNT(R_TASK);
    if (t < kAllNodeSums) {
      const float sum = serial_sum<L::NN>(sh.add[t]);
      if (active) scr[(S_QCFRZ + t) * ncells + cell] = sum;
    } else if (t < kAllNodeSums + 6 * kSegments) {
      const int m = (t - kAllNodeSums) % 6, sg = (t - kAllNodeSums) / 6;
      sh.seg[m][sg] = serial_sum<N>(sh.add[A_M0 + m] + sg * N);
    } else {
      const int sg = t - kAllNodeSums - 6 * kSegments;
      sh.tri[sg] = serial_sum<N>(sh.add[A_TRI] + sg * N);
    }
  }
  __syncwarp();
  if (lane < 6) {
    // the moments of the segments below each segment, added in segment order
    K5_COUNT(R_PREFIX);
    float pre = 0.0f;
#pragma unroll
    for (int sg = 0; sg < kSegments; ++sg) {
      sh.pre[sg][lane] = pre;
      pre = pre + sh.seg[lane][sg];
    }
  }
  __syncwarp();
  // cross-segment blocks against the segments below
#pragma unroll 1
  for (int p = 0; p < L::PER; ++p) {
    const int g = p * G + lane;
    const int sg = g / N;
    if (sg > 0) {
      K5_COUNT(R_CROSS);
      const float* pre = sh.pre[sg];
      const float r = sh.add[A_R][g], v = sh.add[A_V][g], nw = sh.add[A_M0][g];
      const float ci = PV(PI_F) * (r * r * (v * pre[0] - pre[3]) +
                                   2.0f * r * (v * pre[1] - pre[4]) + (v * pre[2] - pre[5]));
      sh.add[A_CROSS][g] = ci * nw;
    }
  }
  __syncwarp();
  if (lane > 0 && lane < kSegments) {
    K5_COUNT(R_CROSS_SUM);
    sh.cross[lane] = serial_sum<N>(sh.add[A_CROSS] + lane * N);
  }
  __syncwarp();
  if (lane == 0 && active) {
    K5_COUNT(R_AGG);
    float agg = 0.0f;
#pragma unroll
    for (int sg = 1; sg < kSegments; ++sg) agg = agg + sh.cross[sg];
#pragma unroll
    for (int sg = 0; sg < kSegments; ++sg) agg = agg + sh.tri[sg];
    scr[S_AGG * ncells + cell] = agg;
  }
}

// ---- K5c: the rates, sedimentation and the update ------------------------

struct CellIn {
  float rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, b_rim;
};

struct CellOut {
  float T_new;
  float dq_lcl, dn_lcl, dq_rai, dn_rai, dq_ice, dn_ice, dq_rim, db_rim;
  float F[kFluxes];  // downward fluxes: q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
};

template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_epilogue(const float* __restrict__ P,
                                                 const CellIn& x,
                                                 const float* __restrict__ rec,
                                                 int64_t ncells, float dt) {
  const float em = PV(EM), en = PV(EN), tiny = PV(TINY);
  CellOut o;

  // bulk_tendencies_2m clamps + the warm rates
  const float rho = maxf(x.rho, 0.0f);
  const float q_tot = maxf(x.q_tot, 0.0f);
  const float q_lcl = maxf(x.q_lcl, 0.0f);
  const float q_rai = maxf(x.q_rai, 0.0f);
  const float n_lcl = maxf(x.n_lcl, 0.0f);
  const float n_rai = maxf(x.n_rai, 0.0f);
  const float q_ice = maxf(x.q_ice, 0.0f);
  const float n_ice = maxf(x.n_ice, 0.0f);
  const WarmRates w =
      warm_rates<LIMITED>(P, x.rho, x.T, x.q_tot, x.q_lcl, x.n_lcl, x.q_rai, x.n_rai, q_ice);
  const float T = x.T;
  const float N_lcl = n_lcl * rho, N_rai = n_rai * rho;
  const bool has_ice = q_ice > em && n_ice > en;

  // the solve's sanitized state and the node pass's sums
  const float s_L = rec[S_L * ncells], s_N = rec[S_N * ncells];
  const float s_F = rec[S_F * ncells], s_rho_rim = rec[S_RHO_RIM * ncells];
  const float QCFRZ = rec[S_QCFRZ * ncells], QCSHD = rec[S_QCSHD * ncells];
  const float NCCOL = rec[S_NCCOL * ncells], QRFRZ = rec[S_QRFRZ * ncells];
  const float QRSHD = rec[S_QRSHD * ncells], NRCOL = rec[S_NRCOL * ncells];
  const float INT_M = rec[S_INT_M * ncells], BCCOL = rec[S_BCCOL * ncells];
  const float BRCOL = rec[S_BRCOL * ncells], INT_WET = rec[S_INT_WET * ncells];
  const float acc_melt = rec[S_MELT * ncells], acc_vn = rec[S_VN * ncells];
  const float acc_vm = rec[S_VM * ncells], agg = rec[S_AGG * ncells];
  const float Lf = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const float e_si = p_sat_ice(P, T);

  // collision sources (ops/p3_processes.py)
  const bool zero_int = INT_M == 0.0f;
  const float f_wet = zero_int ? 0.0f : INT_WET / (zero_int ? 1.0f : INT_M);
  const float NRSHD = QRSHD * PV(INV_M_SHD);
  const bool has_rim = s_rho_rim > 0.0f;
  const float rr_safe = has_rim ? s_rho_rim : 1.0f;
  const float B_rim_c = has_rim ? s_L * s_F / rr_safe : 0.0f;
  const float QIWET = f_wet * s_L * (1.0f - s_F) * PV(INV_TAU_WET);
  const float BIWET = f_wet * (s_L * PV(INV_RHO_I) - B_rim_c) * PV(INV_TAU_WET);
  const float c_dq_c = (-QCFRZ - QCSHD) / rho;
  const float c_dq_r = (-QRFRZ + QCSHD) / rho;
  const float c_dN_c = -NCCOL;
  const float c_dN_r = -NRCOL + NRSHD;
  const float c_dL_rim = QCFRZ + QRFRZ + QIWET;
  const float c_dL_ice = QCFRZ + QRFRZ;
  const float c_dB_rim = BCCOL + BRCOL + BIWET;

  // ice_tendencies_2m_p3 (models/p3_tendencies.py)
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
    const float dNdt = s_N / maxf(s_L, tiny) * dLdt;
    const bool melting = has_ice && T > PV(T_FRZ);
    const float dq_m = (melting ? dLdt : 0.0f) / rho;
    const float dn_m = (melting ? dNdt : 0.0f) / rho;
    dq_rai = dq_rai + dq_m;
    dn_rai = dn_rai + dn_m;
    dq_ice = dq_ice - dq_m;
    dn_ice = dn_ice - dn_m;
    dq_rim = dq_rim - dq_m * s_F;
    db_rim = db_rim - (has_rim ? dq_m * s_F / rr_safe : 0.0f);
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
    dq_rim = dq_rim + dq_sub * s_F;
    db_rim = db_rim + (has_rim ? dq_sub * s_F / rr_safe : 0.0f);
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

  // fall speeds and fluxes (models/column.py)
  const RainSpeeds rs = rain_fall_speeds<LIMITED, CHEN>(P, x.rho, x.q_rai, x.n_rai);
  const bool v_empty = s_N < PV(EPS_MACH) || s_L < PV(EPS_MACH);
  const float vt_n_ice = v_empty ? 0.0f : acc_vn / maxf(s_N, tiny);
  const float vt_m_ice = v_empty ? 0.0f : acc_vm / maxf(s_L, tiny);
  o.F[0] = x.rho * rs.vt_m * x.q_rai;
  o.F[1] = x.rho * rs.vt_n * x.n_rai;
  o.F[2] = x.rho * vt_m_ice * x.q_ice;
  o.F[3] = x.rho * vt_n_ice * x.n_ice;
  o.F[4] = x.rho * vt_m_ice * x.q_rim;
  o.F[5] = x.rho * vt_m_ice * x.b_rim;

  // latent heating, unclamped state
  const float Lf_T = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const float cp = PV(CP_D) + PV(CPVD) * x.q_tot + PV(CPLV) * (x.q_lcl + x.q_rai) +
                   PV(CPIV) * x.q_ice;
  o.T_new = T + dt * (w.Lv * (dq_lcl + dq_rai + dq_ice) + Lf_T * dq_ice) / cp;
  return o;
}

// A block steps `cols` whole columns, a thread per (column, level), the
// level index fastest; blockDim.x == cols * nlev <= kEpiThreads. The warm
// rain's options (LIMITED: the SB2006 rain PSD limiters; CHEN: Chen 2022
// rain fall speeds) are compile-time variants, picked at launch.
template <bool LIMITED, bool CHEN>
__global__ void __launch_bounds__(kEpiThreads, kEpiMinBlocks)
column_p3_epilogue_kernel(Fields f, const float* __restrict__ P,
                          const float* __restrict__ scr, int ncol, int nlev, int cols,
                          float dt, float dz) {
  __shared__ float flux[kFluxes][kEpiThreads];
  const int t = threadIdx.x;
  const int lc = t / nlev;
  const int k = t - lc * nlev;
  const int64_t col = (int64_t)blockIdx.x * cols + lc;
  const bool active = lc < cols && col < ncol;
  const int64_t ncells = (int64_t)ncol * nlev;
  const int64_t idx = col * nlev + k;
  CellIn x;
  CellOut o;
  if (active) {
    K5_COUNT(R_EPI);
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
    o = cell_epilogue<LIMITED, CHEN>(P, x, scr + idx, ncells, dt);
#pragma unroll
    for (int i = 0; i < kFluxes; ++i) flux[i][t] = o.F[i];
  }
  __syncthreads();
  if (active) {
    K5_COUNT(R_EPI_OUT);
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
  }
}

Fields make_fields(const float* const* in, float* const* out, const float* guess,
                   float* loglam) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = in[i];
    f.out[i] = out ? out[i] : nullptr;
  }
  f.guess = guess;
  f.loglam = loglam;
  return f;
}

template <int N>
int launch_nodes(const Fields& f, const float* params, float* scratch, long long ncells,
                 int grid, cudaStream_t s) {
  column_p3_nodes_kernel<N><<<grid, kNodeThreads, 0, s>>>(f, params, scratch, ncells);
  return (int)cudaGetLastError();
}

template <bool LIMITED, bool CHEN>
int launch_epilogue(const Fields& f, const float* params, const float* scratch, int ncol,
                    int nlev, int cols, int grid, float dt, float dz, cudaStream_t s) {
  column_p3_epilogue_kernel<LIMITED, CHEN><<<grid, cols * nlev, 0, s>>>(
      f, params, scratch, ncol, nlev, cols, dt, dz);
  return (int)cudaGetLastError();
}

template <typename K>
int attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace

extern "C" {

int column_p3_num_params() { return N_PARAMS; }

int column_p3_scratch_fields() { return kScratch; }

// threads per block of K5a, K5b and (at most) K5c
int column_p3_threads(int kernel) {
  switch (kernel) {
    case 0: return kSolveThreads;
    case 1: return kNodeThreads;
    case 2: return kEpiThreads;
    default: return 0;
  }
}

// lanes per cell of K5b at a quadrature order (0 without a compiled variant)
int column_p3_lanes_per_cell(int order) {
  switch (order) {
    case 4: return NodePass<4>::G;
    case 8: return NodePass<8>::G;
    case 16: return NodePass<16>::G;
    default: return 0;
  }
}

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

// Registers, local memory bytes, static shared memory bytes and the largest
// block of kernel 0 (K5a), 1 (K5b at `order`) or 2 (K5c, limited rain PSD,
// SB2006 rain fall speeds: the variant of the default parameters).
int column_p3_kernel_attrs(int kernel, int order, int* out) {
  switch (kernel) {
    case 0: return attrs(column_p3_solve_kernel, out);
    case 2: return attrs(column_p3_epilogue_kernel<true, false>, out);
    case 1:
      switch (order) {
        case 4: return attrs(column_p3_nodes_kernel<4>, out);
        case 8: return attrs(column_p3_nodes_kernel<8>, out);
        case 16: return attrs(column_p3_nodes_kernel<16>, out);
      }
  }
  return (int)cudaErrorInvalidValue;
}

// K5a: eleven (ncol, nlev) inputs in ColumnStateP3 order, an optional
// warm-start guess (null for a cold start), the log lambda output and the
// (kScratch, ncells) scratch record; `grid` blocks of kSolveThreads.
int column_p3_solve(const float* const* in, const float* guess, float* loglam, float* scratch,
                    const float* params, long long ncells, int grid, int device,
                    void* stream) {
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f = make_fields(in, nullptr, guess, loglam);
  column_p3_solve_kernel<<<grid, kSolveThreads, 0, (cudaStream_t)stream>>>(f, params, scratch,
                                                                           ncells);
  return (int)cudaGetLastError();
}

// K5b: the node pass of quadrature order `order` over the scratch record;
// `grid` blocks of kNodeThreads, lanes_per_cell(order) lanes per cell.
int column_p3_nodes(const float* const* in, float* scratch, const float* params, int order,
                    long long ncells, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f = make_fields(in, nullptr, nullptr, nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 4: return launch_nodes<4>(f, params, scratch, ncells, grid, s);
    case 8: return launch_nodes<8>(f, params, scratch, ncells, grid, s);
    case 16: return launch_nodes<16>(f, params, scratch, ncells, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5c: the eleven outputs from the inputs and the scratch record; `grid`
// blocks of `cols` whole columns (cols * nlev <= kEpiThreads threads).
int column_p3_epilogue(const float* const* in, float* const* out, const float* scratch,
                       const float* params, int ncol, int nlev, int cols, int grid, float dt,
                       float dz, int limited, int chen, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cols * nlev > kEpiThreads) return (int)cudaErrorInvalidValue;
  const Fields f = make_fields(in, out, nullptr, nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  if (limited)
    return chen ? launch_epilogue<true, true>(f, params, scratch, ncol, nlev, cols, grid, dt, dz, s)
                : launch_epilogue<true, false>(f, params, scratch, ncol, nlev, cols, grid, dt, dz, s);
  return chen ? launch_epilogue<false, true>(f, params, scratch, ncol, nlev, cols, grid, dt, dz, s)
              : launch_epilogue<false, false>(f, params, scratch, ncol, nlev, cols, grid, dt, dz, s);
}

#ifdef K5_PROBE
int column_p3_probe_regions() { return R_COUNT; }

// Per-thread region counters of the next launches: (2 * R_COUNT, stride)
// unsigned ints, stride at least the launch's threads.
int column_p3_probe_set(unsigned int* counts, long long stride, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_probe, &counts, sizeof(counts));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_probe_stride, &stride, sizeof(stride));
  return (int)err;
}
#endif

}  // extern "C"
