// 2-moment warm rain + P3 ice column step: one explicit Euler step of
// models/column.py:step_column_p3 over (ncol, nlev) columns of the eleven
// prognostic fields (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice,
// n_ice, q_rim, b_rim), with an optional warm-start log lambda, to the
// eleven new fields and the solved log lambda.
//
// Replaces the Pallas TPU kernel cloudmicrophysics_tpu/kernels/column_p3.py:
// step_column_p3_pallas, which re-runs the XLA step on a tile, so it takes
// every option the step takes. Here each option that changes the code is a
// build of this source (the macros of the generated header,
// kernels/column_p3.py:variant): the scalar type K5_REAL (float or double),
// the quadrature order K5_ORDER (any: Gauss-Legendre or Chebyshev-Gauss, the
// tables are data), the slope law (K5_SLOPE_CONSTANT), the aspect ratio of
// the fall speed (K5_OBLATE) and the ice container's rain PSD limiters
// (K5_ICE_RAIN_LIMITED). The warm rain's limiters and fall speeds are
// templates of K5c, picked at launch; every float parameter is data.
//
// What bounds it on an H100: not HBM (48 B read and 48 B written per cell
// at float32) but the instruction stream. Per cell: some ten shape-solve
// residuals of six fixed-trip incomplete gammas each, four inverse
// incomplete gammas, and for each of the 4 x N ice quadrature nodes a dozen
// exp/log/pow calls, 2 x N_L liquid pairs and the fresh inner nodes of the
// self-collection triangle (about 350 ice-particle evaluations per cell at
// N = 16). The design spreads that work over enough threads to keep the
// card's issue slots busy, in three kernels on the caller's stream, joined
// by a structure-of-arrays scratch record of kScratch values per cell
// (PERF.md gives each kernel's time, instructions and share of the issue
// rate):
//
//   K5a (column_p3_solve_kernel): a thread per cell over the flat
//     ncol * nlev grid: the raw-state shape solve (fixed-iteration
//     branchless Brent over the segment-summed log mass moment, 8 iterations
//     at float32 and 10 at float64, warm-started when a guess is given; log
//     lambda out), the sanitized state of p3_step_aux, mu, lambda, log N0,
//     the five ice integration bounds and the cloud window of the
//     collisions (4 Halley steps of the inverse incomplete gamma each). Its
//     time goes to the latency of dependent chains of IEEE divisions (the
//     incomplete gammas' recurrences), so it runs many warps
//     (kSolveMinBlocks blocks per SM, spilling a little), evaluates only the
//     branch of an incomplete gamma that it keeps, runs a residual's six
//     incomplete gammas two at a time per branch (two chains in flight, the
//     lanes of a warp on one branch's code), evaluates a residual's log
//     gammas once per distinct segment shape, and the cloud window's
//     parameter-only inverse gammas once per block. It also computes the
//     node pass's per-cell factors (fall-speed and rain coefficients, PSD
//     windows, freezing factors), a thread per cell rather than a warp per
//     cell.
//   K5b (column_p3_nodes_kernel<N>): G lanes per cell (4N when that divides
//     a warp, else a warp), which walk the cell's 4N ice nodes in node order
//     in chunks of PER x G, PER nodes per lane (two at float32, one at
//     float64). The last chunk runs only the lane passes that hold a node
//     (min(PER, ceil(its nodes / G)), the same for every lane of the
//     warp); in such a pass the lanes past the last node evaluate the last
//     node and store nothing that is summed. Every order up to 16 at
//     float32 is one chunk (GL-16's 64 nodes, two per lane). The cell's
//     liquid node factors are computed into shared memory and read by
//     broadcast (once per cell up to kMaxLiq liquid nodes, else once per
//     chunk of them, each lane carrying its collision sums across the
//     liquid chunks). Each lane evaluates its nodes (Chen 2022 +
//     aspect-ratio velocity, PSD weight, liquid x ice collisions with the
//     Musil freezing/shedding split and wet growth, melt, fall-speed
//     moments, the within-segment self-collection triangle) and writes
//     every per-node addend of the chunk to shared memory. Then each
//     node-axis sum adds the chunk's nodes one at a time in node order, one
//     lane per sum, carrying its accumulator in a register from chunk to
//     chunk (its length known at compile time where the layout allows: a
//     serial sum is a chain of dependent adds whose shared loads the
//     compiler must be able to issue ahead): the ten collision sums, melt
//     and the two fall-speed sums over all nodes; each segment's six
//     moments, and once a segment's last node is in, the prefix moments of
//     the segments above it; then the cross-segment addends of the chunk's
//     nodes and their per-segment sums, and the aggregation rate. Shared
//     memory is one chunk's addends and at most kMaxLiq liquid nodes'
//     factors a cell, whatever the order.
//   K5c (column_p3_epilogue_kernel<LIMITED, CHEN>): a thread per (column,
//     level) in blocks of whole columns, walking a column's levels from the
//     top in chunks of at most kEpiThreads and carrying the inflow fluxes
//     from one chunk to the next (one chunk when nlev <= kEpiThreads): F23
//     deposition nucleation, F23-capped Bigg immersion freezing,
//     sublimation/deposition, ice number adjustment, Bigg rain freezing, the
//     SB2006 warm rates (warm2m.cuh, shared with column2m.cu), rain and ice
//     sedimentation (six fluxes of level k + 1 through shared memory),
//     latent heating, the clamp and q_rim <= q_ice.
//
// Built with -DK5_TEND, the source is instead the point-wise fused
// tendencies of models/tendencies.py:bulk_tendencies_2m with P3 ice (no
// column, no sedimentation, no update): K5a as column_p3_bounds_kernel,
// which takes log lambda as an input (the host's solve) and clamps rho as
// bulk_tendencies_2m does before p3_step_aux, then K5b (skipping a warp
// whose cells hold no ice, and counting the cells it ran), then
// column_p3_tend_rates_kernel<LIMITED, CHEN>, a thread per point running
// K5c's cell_epilogue with a per-point INP log shift (none: 0) and writing
// the eight rates. Without K5_TEND the source is the column step above,
// token for token but the probe's region R_TEND.
//
// Rounding: a float32 build is built with --fmad=false, a float64 build
// computes on real.cuh's uncontracted Dbl with --fmad=true (real.cuh says
// why), neither with fast math, and each expression follows the eager
// PyTorch step's operation order as PyTorch's CUDA kernels evaluate it (see
// warm2m.cuh), with the parameters folded on the host as the eager code
// folds its Python floats. Each per-node value is computed by one lane with
// the code and operation order of a serial pass, and every node-axis sum of
// the eager step runs one node at a time in node order
// (utils/quadrature.py:sum_nodes), as K5b's serial sums do: no tree
// reduction and no atomics. Where an operation rounded differently, discrete
// arms could flip on a last-bit difference: the wet-growth test
// dM_col > dM_frz (ops/p3_processes.py), the regime select at the segment
// thresholds, and the Brent accept test.
//
// Infinities: D_gr and D_cr are +inf for unrimed ice, collapsed segments
// carry zero weight and -inf log moments (excluded from the logsumexp), and
// cells without ice run the node pass on the placeholder state of
// p3_step_aux and are masked, as in the eager step; with K5_TEND a warp
// whose cells all lack ice skips the node pass, whose sums the rates
// kernel would discard.
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
  R_EPI, R_EPI_OUT, R_TEND,
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

// the build's variant (kernels/column_p3.py:variant)
using scalar = K5_REAL;            // the state's dtype: float or double
using real = Real<scalar>::type;   // what the cells compute on (real.cuh)
constexpr bool kF64 = sizeof(scalar) == 8;
constexpr int kOrder = K5_ORDER;                   // ice nodes per segment
constexpr bool kSlopeConstant = K5_SLOPE_CONSTANT;  // else SlopePowerLaw
constexpr bool kOblate = K5_OBLATE;                 // else NoAspectRatio
constexpr bool kIceRainLimited = K5_ICE_RAIN_LIMITED;

constexpr int kFields = 11;
constexpr int kFluxes = 6;
constexpr int kSegments = 4;
// threads per block and blocks per SM each kernel is compiled for (a float64
// build keeps about twice the registers a thread)
constexpr int kSolveThreads = 128, kSolveMinBlocks = kF64 ? 4 : 16;
constexpr int kNodeThreads = 128;
constexpr int kEpiThreads = 256, kEpiMinBlocks = kF64 ? 1 : 2;
// liquid nodes whose factors K5b holds in shared memory at once
constexpr int kMaxLiq = 64;
// iterations of the incomplete gamma's series and continued fraction
// (utils/special.py:_maxiters), the unroll factor of their loops, and of the
// shape solve's Brent (ops/p3.py:get_distribution_loglambda)
constexpr int kGiTrips = kF64 ? 30 : 20;
constexpr int kGiUnroll = kF64 ? 2 : 4;
constexpr int kBrentIters = kF64 ? 10 : 8;
// offsets of the second parameter blocks (ice rain PSD, ice Chen rain)
constexpr int kIceRainPDF = P_IR_XR_MIN - P_XR_MIN;
constexpr int kIceChen = P_IC_RHO0 - P_CH_RHO0;

__device__ __forceinline__ real r_inf() { return real((scalar)INFINITY); }
__device__ __forceinline__ real r_nan() { return real((scalar)NAN); }

// Quadrature orders of a build: ice nodes per segment, liquid nodes,
// self-collection inner nodes (tail segment: NT), as ops/p3_processes.py's
// liquid_quadrature and self_collection_inner_orders choose them
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

__device__ __forceinline__ real lgamma_pos(const scalar* __restrict__ P, real z) {
  constexpr real c[9] = {
      real(0.99999999999980993), real(676.5203681218851),
      real(-1259.1392167224028), real(771.32342877765313),
      real(-176.61502916214059), real(12.507343278686905),
      real(-0.13857109526572012), real(9.9843695780195716e-6),
      real(1.5056327351493116e-7)};
  z = maxf(z, PV(TINY)) - real(1);
  real series = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) series = series + rdiv(c[i], z + real(i));
  const real t = z + real(7) + real(0.5);
  return PV(HALF_LOG_2PI) + (z + real(0.5)) * log_(t) - t + log_(series);
}

struct PQ {
  real p, q;
};

// utils/special.py:_gamma_inc_core: the series (kGiTrips terms) when
// x < a + 1, else the Lentz continued fraction (kGiTrips iterations), no
// early exit. The plain step evaluates both and selects one; only the
// selected one is evaluated here, with the same operations, so the result
// is the same.
__device__ __forceinline__ real gi_series(const scalar* __restrict__ P, real a, real x,
                                          real factor) {
  K5_COUNT(R_GI_SERIES);
  const real a_safe = maxf(a, PV(TINY));
  real term = rdiv(real(1), a_safe);
  real sum_p = term;
#pragma unroll (kGiUnroll)
  for (int k = 1; k <= kGiTrips; ++k) {
    K5_COUNT(R_GI_SERIES_IT, kGiUnroll);
    term = term * x / (a_safe + real(k));
    sum_p = sum_p + term;
  }
  return clampf(factor * sum_p, real(0), real(1));
}

__device__ __forceinline__ real gi_cf(const scalar* __restrict__ P, real a, real x,
                                      real factor) {
  K5_COUNT(R_GI_CF);
  const real tiny = PV(GI_TINY);
  const real b1 = x + real(1) - a;
  real c = b1 + PV(GI_BIG);
  real d = rdiv(real(1), fabs_(b1) < tiny ? tiny : b1);
  real h = d;
#pragma unroll (kGiUnroll)
  for (int k = 1; k <= kGiTrips; ++k) {
    K5_COUNT(R_GI_CF_IT, kGiUnroll);
    const real ak = real(-k) * (real(k) - a);
    const real bk = x + real(2 * k) + real(1) - a;
    const real d_tmp = bk + ak * d;
    d = fabs_(d_tmp) < tiny ? tiny : d_tmp;
    const real c_tmp = bk + ak / c;
    c = fabs_(c_tmp) < tiny ? tiny : c_tmp;
    d = rdiv(real(1), d);
    h = h * (c * d);
  }
  return clampf(factor * h, real(0), real(1));
}

// _gamma_inc_core's special arguments, after its branch
__device__ __forceinline__ PQ gi_finish(PQ r, real a, real x) {
  if (x <= real(0)) {
    r.p = real(0);
    r.q = real(1);
  }
  if (x == r_inf()) {
    r.p = real(1);
    r.q = real(0);
  }
  if (isnan_(x) || isnan_(a)) r.p = r.q = r_nan();
  return r;
}

__device__ __forceinline__ PQ gamma_inc_core(const scalar* __restrict__ P, real a,
                                             real x, real lga) {
  const bool use_series = x < a + real(1);
  const real factor = exp_(a * log_(maxf(x, PV(TINY))) - x - lga);
  PQ r;
  if (use_series) {
    const real P_series = gi_series(P, a, x, factor);
    r.p = P_series;
    r.q = real(1) - P_series;
  } else {
    const real Q_cf = gi_cf(P, a, x, factor);
    r.p = real(1) - Q_cf;
    r.q = Q_cf;
  }
  return gi_finish(r, a, x);
}

// gi_series and gi_cf on two arguments at once: each chain is the single
// evaluation's operations; the two are independent, so a thread keeps two
// dependent chains of divisions in flight
__device__ __forceinline__ void gi_series2(const scalar* __restrict__ P, real a1, real x1,
                                           real f1, real a2, real x2, real f2,
                                           real& r1, real& r2) {
  K5_COUNT(R_GI_SERIES2);
  const real a_safe1 = maxf(a1, PV(TINY)), a_safe2 = maxf(a2, PV(TINY));
  real term1 = rdiv(real(1), a_safe1), term2 = rdiv(real(1), a_safe2);
  real sum1 = term1, sum2 = term2;
#pragma unroll (kGiUnroll)
  for (int k = 1; k <= kGiTrips; ++k) {
    K5_COUNT(R_GI_SERIES2_IT, kGiUnroll);
    term1 = term1 * x1 / (a_safe1 + real(k));
    term2 = term2 * x2 / (a_safe2 + real(k));
    sum1 = sum1 + term1;
    sum2 = sum2 + term2;
  }
  r1 = clampf(f1 * sum1, real(0), real(1));
  r2 = clampf(f2 * sum2, real(0), real(1));
}

__device__ __forceinline__ void gi_cf2(const scalar* __restrict__ P, real a1, real x1,
                                       real f1, real a2, real x2, real f2, real& r1,
                                       real& r2) {
  K5_COUNT(R_GI_CF2);
  const real tiny = PV(GI_TINY);
  const real b1_1 = x1 + real(1) - a1, b1_2 = x2 + real(1) - a2;
  real c1 = b1_1 + PV(GI_BIG), c2 = b1_2 + PV(GI_BIG);
  real d1 = rdiv(real(1), fabs_(b1_1) < tiny ? tiny : b1_1);
  real d2 = rdiv(real(1), fabs_(b1_2) < tiny ? tiny : b1_2);
  real h1 = d1, h2 = d2;
#pragma unroll (kGiUnroll)
  for (int k = 1; k <= kGiTrips; ++k) {
    K5_COUNT(R_GI_CF2_IT, kGiUnroll);
    const real ak1 = real(-k) * (real(k) - a1);
    const real ak2 = real(-k) * (real(k) - a2);
    const real bk1 = x1 + real(2 * k) + real(1) - a1;
    const real bk2 = x2 + real(2 * k) + real(1) - a2;
    const real d_tmp1 = bk1 + ak1 * d1;
    const real d_tmp2 = bk2 + ak2 * d2;
    d1 = fabs_(d_tmp1) < tiny ? tiny : d_tmp1;
    d2 = fabs_(d_tmp2) < tiny ? tiny : d_tmp2;
    const real c_tmp1 = bk1 + ak1 / c1;
    const real c_tmp2 = bk2 + ak2 / c2;
    c1 = fabs_(c_tmp1) < tiny ? tiny : c_tmp1;
    c2 = fabs_(c_tmp2) < tiny ? tiny : c_tmp2;
    d1 = rdiv(real(1), d1);
    d2 = rdiv(real(1), d2);
    h1 = h1 * (c1 * d1);
    h2 = h2 * (c2 * d2);
  }
  r1 = clampf(f1 * h1, real(0), real(1));
  r2 = clampf(f2 * h2, real(0), real(1));
}

__device__ __forceinline__ real poly6(const real (&cs)[6], real x) {
  real r = cs[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) r = r * x + cs[i];
  return r;
}

__device__ __forceinline__ real poly5(const real (&cs)[5], real x) {
  real r = cs[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) r = r * x + cs[i];
  return r;
}

__device__ __forceinline__ real poly4(const real (&cs)[4], real x) {
  real r = cs[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) r = r * x + cs[i];
  return r;
}

// utils/special.py:_ndtri_acklam
__device__ __forceinline__ real ndtri_acklam(const scalar* __restrict__ P, real p) {
  constexpr real A[6] = {real(-3.969683028665376e+01), real(2.209460984245205e+02),
                         real(-2.759285104469687e+02), real(1.383577518672690e+02),
                         real(-3.066479806614716e+01), real(2.506628277459239e+00)};
  constexpr real B[5] = {real(-5.447609879822406e+01), real(1.615858368580409e+02),
                         real(-1.556989798598866e+02), real(6.680131188771972e+01),
                         real(-1.328068155288572e+01)};
  constexpr real C[6] = {real(-7.784894002430293e-03), real(-3.223964580411365e-01),
                         real(-2.400758277161838e+00), real(-2.549732539343734e+00),
                         real(4.374664141464968e+00), real(2.938163982698783e+00)};
  constexpr real D[4] = {real(7.784695709041462e-03), real(3.224671290700398e-01),
                         real(2.445134137142996e+00), real(3.754408661907416e+00)};
  constexpr real lo_tail = real(0.02425);
  constexpr real hi_tail = real(1.0 - 0.02425);
  const real p_c = clampf(p, PV(TINY), PV(ONE_M_EPS));
  const real qc = p_c - real(0.5);
  const real r = qc * qc;
  const real x_mid = qc * poly6(A, r) / (poly5(B, r) * r + real(1));
  const real ql = sqrt_(real(-2) * log_(p_c < lo_tail ? p_c : real(0.01)));
  const real x_lo = poly6(C, ql) / (poly4(D, ql) * ql + real(1));
  const real qu = sqrt_(real(-2) * log_(p_c > hi_tail ? real(1) - p_c : real(0.01)));
  const real x_hi = -poly6(C, qu) / (poly4(D, qu) * qu + real(1));
  return p_c < lo_tail ? x_lo : (p_c > hi_tail ? x_hi : x_mid);
}

// utils/special.py:gamma_inc_inv with 4 Halley iterations (the integration
// bounds' count)
__device__ __noinline__ real gamma_inc_inv4(const scalar* __restrict__ P, real a,
                                            real p, real q) {
  K5_COUNT(R_INV);
  const real tiny = PV(TINY);
  const real eps = PV(EPS_MACH);
  const real p_safe = maxf(p, tiny);
  const real q_safe = maxf(q, tiny);
  const real lga = lgamma_pos(P, a);
  const real a_safe = maxf(a, tiny);
  const real guess_lo = exp_((log_(p_safe) + lgamma_pos(P, a + real(1))) / a_safe);
  const real z = -ndtri_acklam(P, q_safe);
  const real t_wh = real(1) - rdiv(real(1), real(9) * a_safe) + z / (real(3) * sqrt_(a_safe));
  const real guess_ref = a - log_(q_safe);
  real guess_hi = t_wh > real(0.1) ? a * (t_wh * t_wh * t_wh) : guess_ref;
  const real L_tail = -log_(q_safe);
  const real guess_tail = L_tail + (a - real(1)) * log_(maxf(L_tail, real(1))) - lga;
  if (L_tail > real(60) && guess_tail > real(3) * a) guess_hi = maxf(guess_tail, tiny);
  real x = (p < real(0.5) || guess_lo < real(0.5)) ? guess_lo : guess_hi;
  x = maxf(x, tiny);

  const bool use_q = p > real(0.5);
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    K5_COUNT(R_INV_IT);
    const PQ g = gamma_inc_core(P, a, x, lga);
    const real f = use_q ? g.q - q : g.p - p;
    const real x_pos = maxf(x, tiny);
    const real fm = exp_((a - real(1)) * log_(x_pos) - x - lga);
    const real fprime = use_q ? -fm : fm;
    const bool fp_zero = fprime == real(0);
    const real fps = fp_zero ? real(1) : fprime;
    const real f2 = (a - real(1) - x) / x_pos;
    const real denom = real(1) - real(0.5) * f / fps * f2;
    real step = f / (fps * denom);
    step = (x - step <= real(0)) ? real(0.5) * x : step;
    const real x_new = x - step;
    const bool done_pre = done || fp_zero;
    x = done_pre ? x : x_new;
    done = done_pre || fabs_(step) < eps * x_new;
  }
  if (p <= real(0)) x = real(0);
  if (q <= real(0)) x = r_inf();
  if (isnan_(a) || isnan_(p) || isnan_(q)) x = r_nan();
  return x;
}

// ---------------------------------------------------------------------------
// ops/p3.py: the P3 state, regime laws and size distribution
// ---------------------------------------------------------------------------

struct P3S {
  real L, N, F, rho_rim, rho_g, D_th, D_gr, D_cr;
};

// utils/special.py:sgs_weight_function with a_half = machine eps
__device__ __forceinline__ real sgs_weight(const scalar* __restrict__ P, real a) {
  const real eps = PV(EPS_MACH);
  const real a_s = clampf(a, eps, PV(SGS_UPPER));
  real inner = real(1) - real(2) * tpow(real(1) - a_s, PV(SGS_K));
  inner = clampf(inner, PV(SGS_LO), PV(ONE_M_EPS));
  real w = (real(1) + tanh_(real(2) * atanh_(inner))) * real(0.5);
  w = a < real(0) ? real(0) : w;
  w = real(4) * a < eps ? real(0) : w;
  return a > PV(SGS_HI) ? real(1) : w;
}

// utils/special.py:regularised_ratio (half = eps, eps = eps^2)
__device__ __forceinline__ real regularised_ratio(const scalar* __restrict__ P,
                                                  real num, real den) {
  const real w = sgs_weight(P, den);
  const bool small = den < PV(EPS2);
  const real out = w * num / (small ? real(1) : den);
  return small ? real(0) : out;
}

__device__ __forceinline__ real exprel1(real x) {
  const bool small = fabs_(x) < real(1e-8);
  const real xs = small ? real(1) : x;
  const real out = expm1_(xs) / xs;
  return small ? real(1) + x * real(0.5) : out;
}

__device__ __forceinline__ real exprel2(real x) {
  // 1/(i+1)! for i = 8 .. 1, Horner order
  constexpr real c[8] = {real(1.0 / 362880.0), real(1.0 / 40320.0),
                         real(1.0 / 5040.0),   real(1.0 / 720.0),
                         real(1.0 / 120.0),    real(1.0 / 24.0),
                         real(1.0 / 6.0),      real(1.0 / 2.0)};
  const bool small = fabs_(x) < real(0.2);
  const real xs = small ? real(1) : x;
  const real direct = (expm1_(xs) - xs) / (xs * xs);
  real taylor = real(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) taylor = taylor * x + c[i];
  return small ? taylor : direct;
}

// ops/p3.py:_threshold
__device__ __forceinline__ real threshold(const scalar* __restrict__ P, real rho) {
  return tpow(rdiv(PV(SIX_ALPHA), rho * PV(PI_F)), PV(THR_EXP));
}

// ops/p3.py:state_from_prognostic (+ p3_state, get_rho_d, get_rho_g)
__device__ __forceinline__ P3S state_from_prognostic(const scalar* __restrict__ P,
                                                     real L, real N, real L_rim,
                                                     real B_rim) {
  K5_COUNT(R_STATE);
  const real eps = PV(EPS_MACH);
  P3S s;
  s.L = L;
  s.N = N;
  s.F = minf(regularised_ratio(P, minf(L_rim, L), L), PV(ONE_M_EPS));
  s.rho_rim = minf(regularised_ratio(P, L_rim, B_rim), PV(RHO_RIM_MAX));
  // get_rho_d
  const real F = minf(s.F, PV(ONE_M_EPS));
  const real logFu = log1p_(-F);
  const real phi1 = exprel1(logFu);
  const real phi1mp = exprel1(PV(RHOD_1MP) * logFu);
  const real H = PV(RHOD_NEGP) * exprel2(PV(RHOD_NEGP) * logFu) -
                 PV(RHOD_1MP) * exprel2(PV(RHOD_1MP) * logFu);
  const real G = H - phi1mp * phi1;
  const real rho_d = -(s.rho_rim * phi1 * phi1mp) / G;
  s.rho_g = s.F * s.rho_rim + (real(1) - s.F) * rho_d;
  s.D_th = PV(D_TH);
  const bool unrimed = s.F == real(0);
  const real rgs = unrimed ? real(1) : s.rho_g;
  s.D_gr = unrimed ? r_inf() : threshold(P, rgs);
  s.D_cr = unrimed ? r_inf() : threshold(P, rgs * maxf(real(1) - s.F, eps));
  return s;
}

__device__ __forceinline__ real regime(const P3S& s, real D, real small, real unrimed,
                                       real dense, real graupel, real partial) {
  return D < s.D_th ? small
                    : (s.F == real(0) ? unrimed
                                      : (D < s.D_gr ? dense : (D < s.D_cr ? graupel : partial)));
}

struct MassCoeffs {
  real a, b;
};

// ops/p3.py:ice_mass_coeffs
__device__ __forceinline__ MassCoeffs mass_coeffs(const scalar* __restrict__ P,
                                                  const P3S& s, real D) {
  const real alpha = PV(ALPHA_VA), beta = PV(BETA_VA);
  const real Fu = maxf(real(1) - s.F, PV(EPS_MACH));
  MassCoeffs m;
  m.a = regime(s, D, PV(RHOI_PI6), alpha, alpha, s.rho_g * PV(PI_F) * sixth<real>(),
               rdiv(alpha, Fu));
  m.b = regime(s, D, real(3), beta, beta, real(3), beta);
  return m;
}

// ops/p3.py:ice_area
__device__ __forceinline__ real ice_area(const scalar* __restrict__ P, const P3S& s,
                                         real D) {
  const real sph = D * D * PV(PI_F) * real(0.25);
  const real non = PV(AREA_GAMMA) * tpow(D, PV(AREA_SIGMA));
  return regime(s, D, sph, non, non, sph, s.F * sph + (real(1) - s.F) * non);
}

// ops/common.py:chen2022_vel_coeffs_small_ice / _large_ice at the cell's air
// density: the a_i, b_i and c_i of the two small-ice and two large-ice terms
struct IceVel {
  real as0, as1, bs, al0, al1;
};

__device__ __forceinline__ IceVel ice_vel_coeffs(const scalar* __restrict__ P,
                                                 real rho) {
  const real rho_a = maxf(rho, real(0));
  const real log_rho = log_(rho_a);
  IceVel c;
  const real bi_common = rho_a * PV(CS_C) + PV(CS_B);
  const real rho_pow_s = exp_(PV(CS_A) * log_rho);
  const real unit = exp_(bi_common * PV(LOG1000));
  c.as0 = PV(CS_E) * rho_pow_s * unit;
  c.as1 = PV(CS_F) * rho_pow_s * unit;
  c.bs = bi_common;
  const real rho_pow_l = exp_(PV(CL_A) * log_rho);
  c.al0 = PV(CL_B) * rho_pow_l * PV(CL_U0);
  c.al1 = PV(CL_E) * rho_pow_l * exp_(PV(CL_H) * rho_a) * PV(CL_U1);
  return c;
}

// What one evaluation of the ice particle at diameter D gives: its Chen 2022
// fall speed (times the aspect-ratio factor of an Oblate build), mass and
// cross-sectional area
struct IceParticle {
  real v, m, area, log_D;
};

// ops/p3.py:ice_particle_terminal_velocity (with aspect_ratio_factor, phi_i,
// ice_mass, ice_area)
__device__ __forceinline__ IceParticle ice_particle(const scalar* __restrict__ P,
                                                    const P3S& s, const IceVel& c,
                                                    real D) {
  const real log_D = log_(D);
  const real v_small = c.as0 * exp_(c.bs * log_D - PV(CS_C0U) * D) +
                       c.as1 * exp_(c.bs * log_D - PV(CS_C1U) * D);
  const real v_large = c.al0 * exp_(PV(CL_B0) * log_D - PV(CL_C0U) * D) +
                       c.al1 * exp_(PV(CL_B1) * log_D - PV(CL_C1U) * D);
  const real v = D <= PV(CUTOFF) ? v_small : v_large;
  const MassCoeffs mc = mass_coeffs(P, s, D);
  IceParticle o;
  o.m = mc.a * pow_(D, mc.b);
  o.area = ice_area(P, s, D);
  if (kOblate) {
    const real rho = regime(s, D, PV(RHO_I), PV(RHO_I), PV(RHO_I), s.rho_g, PV(RHO_I));
    const real a_safe = maxf(o.area, PV(TINY));
    real phi = PV(THREE_SQRT_PI) * o.m / (real(4) * rho * a_safe * sqrt_(a_safe));
    phi = D == real(0) ? real(0) : phi;
    const real sgn = real((real(0) < phi) - (phi < real(0)));
    o.v = v * (sgn * tpow(fabs_(phi), third<real>()));
  } else {
    // NoAspectRatio: the factor is ones_like(D)
    o.v = v * real(1);
  }
  o.log_D = log_D;
  return o;
}

// ops/p3.py:get_mu (SlopePowerLaw, or SlopeConstant: mu + zeros_like)
__device__ __forceinline__ real get_mu(const scalar* __restrict__ P, real ll) {
  if (kSlopeConstant) return PV(SLOPE_MU) + real(0);
  return clampf(PV(SLOPE_A) * tpow(exp_(ll), PV(SLOPE_B)) - PV(SLOPE_C), real(0),
                PV(MU_MAX));
}

// ops/p3.py:loggamma_moment (k = 0, scale = 1)
__device__ __forceinline__ real loggamma_moment(real mu, real ll) {
  const real z = mu + real(0) + real(1);
  return -z * ll + lgamma_(z) + real(0);
}

// logLdivN's two log gammas of a segment's shape z: the Lanczos one of the
// incomplete gammas and lgamma of the log moment
__device__ __forceinline__ void seg_lgamma(const scalar* __restrict__ P, real z, real& lgz,
                                           real& lgf) {
  K5_COUNT(R_LGAMMA);
  lgz = lgamma_pos(P, z);
  lgf = lgamma_(z);
}

// v[c] for a run-time c, without an indexed (local memory) array
template <int n>
__device__ __forceinline__ real pick(const real (&v)[n], int c) {
  real r = v[0];
#pragma unroll
  for (int i = 1; i < n; ++i) r = c == i ? v[i] : r;
  return r;
}

template <int n>
__device__ __forceinline__ void put(real (&v)[n], int c, real x) {
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
__device__ __noinline__ real logLdivN(const scalar* __restrict__ P, const P3S s,
                                      real ll) {
  K5_COUNT(R_LOGLDIVN);
  const real mu = get_mu(P, ll);
  const real e = exp_(ll);
  const real inf = r_inf();
  const real bnds[5] = {real(0), minf(maxf(s.D_th, real(0)), inf),
                        minf(maxf(s.D_gr, real(0)), inf),
                        minf(maxf(s.D_cr, real(0)), inf), inf};
  real z[kSegments], lgz[kSegments], lgf[kSegments];
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    const MassCoeffs mc = mass_coeffs(P, s, (bnds[i] + bnds[i + 1]) * real(0.5));
    z[i] = mc.b + real(0) + mu + real(1);
  }
  // the segments' log gammas, each evaluated once per distinct shape (the
  // regimes give two: z0 = z2 and z1 = z3 for rimed ice, z1 = z2 = z3 for
  // unrimed): an equal argument gives the equal result
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
  const real xb[3] = {bnds[1] * e, bnds[2] * e, bnds[3] * e};
  real gf[6], v[6];
  unsigned series = 0u;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int sg = c < 3 ? c + 1 : c - 3;
    const real a = z[sg], x = xb[c % 3];
    gf[c] = exp_(a * log_(maxf(x, PV(TINY))) - x - lgz[sg]);
    v[c] = real(0);
    if (x < a + real(1)) series |= 1u << c;
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
    const real a1 = pick(z, c1 < 3 ? c1 + 1 : c1 - 3), a2 = pick(z, c2 < 3 ? c2 + 1 : c2 - 3);
    real r1, r2;
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
    const real a1 = pick(z, c1 < 3 ? c1 + 1 : c1 - 3), a2 = pick(z, c2 < 3 ? c2 + 1 : c2 - 3);
    real r1, r2;
    gi_cf2(P, a1, pick(xb, c1 % 3), pick(gf, c1), a2, pick(xb, c2 % 3), pick(gf, c2), r1,
           r2);
    put(v, c1, r1);
    put(v, c2, r2);
  }
  PQ g[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const bool ser = (series >> c) & 1u;
    g[c].p = ser ? v[c] : real(1) - v[c];
    g[c].q = ser ? real(1) - v[c] : v[c];
    g[c] = gi_finish(g[c], z[c < 3 ? c + 1 : c - 3], xb[c % 3]);
  }
  real m[kSegments];
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    const real lo = bnds[i], hi = bnds[i + 1];
    PQ g1, g2;
    real x2;
    if (i == 0) {
      g1.p = real(0);
      g1.q = real(1);
    } else {
      g1 = g[i - 1];
    }
    if (i == kSegments - 1) {
      g2.p = real(1);
      g2.q = real(0);
      x2 = inf;
    } else {
      x2 = hi * e;
      g2 = g[i + 3];
    }
    real dq = x2 < z[i] + real(1) ? g2.p - g1.p : g1.q - g2.q;
    dq = maxf(dq, PV(EPS_MACH));
    real out = -z[i] * ll + lgf[i] + log_(dq) + real(0);
    out = lo < hi ? out : -inf;
    out = out + log_(maxf(mass_coeffs(P, s, (lo + hi) * real(0.5)).a, PV(TINY)));
    m[i] = lo < hi ? out : -inf;
  }
  // utils/special.py:logsumexp
  real xmax = m[0];
#pragma unroll
  for (int i = 1; i < kSegments; ++i) xmax = m[i] > xmax ? m[i] : xmax;
  const bool finite = isfinite_(xmax);
  const real shift = finite ? xmax : real(0);
  real sum = exp_(m[0] - shift);
#pragma unroll
  for (int i = 1; i < kSegments; ++i) sum = sum + exp_(m[i] - shift);
  const real lse = finite ? shift + log_(sum) : xmax;
  return lse - loggamma_moment(mu, ll);
}

// ops/p3.py:get_distribution_loglambda: fixed-iteration branchless Brent
// over [2, 17], narrowed by the warm-start guess when there is one
__device__ __forceinline__ real shape_solve(const scalar* __restrict__ P, const P3S& s,
                                            bool warm_start, real guess) {
  const real tiny = PV(TINY);
  const bool empty = s.N < PV(EN) || s.L < PV(EM);
  if (empty) return -r_inf();
  const real target = log_(maxf(s.L, tiny)) - log_(maxf(s.N, tiny));
  real lo = real(2), hi = real(17);
  real f_lo = logLdivN(P, s, lo) - target;
  real f_hi = logLdivN(P, s, hi) - target;
  const bool degenerate = !isfinite_(f_lo) || !isfinite_(f_hi) || f_lo * f_hi > real(0);
  const real endpoint = fabs_(f_lo) <= fabs_(f_hi) ? lo : hi;
  if (degenerate) return endpoint;
  if (warm_start) {
    const real p = guess + real(0);
    bool valid = isfinite_(p) && lo < p && p < hi;
    const real pc = valid ? p : lo;
    const real f_p = logLdivN(P, s, pc) - target;
    valid = valid && isfinite_(f_p);
    const bool left = valid && f_lo * f_p < real(0);
    const bool right = valid && !left;
    hi = left ? pc : hi;
    f_hi = left ? f_p : f_hi;
    lo = right ? pc : lo;
    f_lo = right ? f_p : f_lo;
  }
  // _brent_fixed
  real a = lo, fa = f_lo, b = hi, fb = f_hi, c = b, fc = fb;
  real d = b - a, e = b - a;
#pragma unroll 1
  for (int it = 0; it < kBrentIters; ++it) {
    K5_COUNT(R_BRENT_IT);
    const bool same_sign = fb * fc > real(0);
    if (same_sign) {
      c = a;
      fc = fa;
      d = b - a;
      e = b - a;
    }
    if (fabs_(fc) < fabs_(fb)) {
      a = b;
      b = c;
      c = a;
      fa = fb;
      fb = fc;
      fc = fa;
    }
    const real tol1 = PV(TWO_EPS) * fabs_(b);
    const real xm = (c - b) * real(0.5);
    const bool can_interp = fabs_(e) >= tol1 && fabs_(fa) > fabs_(fb);
    const real fa_safe = fabs_(fa) > real(0) ? fa : tiny;
    const real fc_safe = fabs_(fc) > real(0) ? fc : tiny;
    const real sr = fb / fa_safe;
    const bool secant = a == c;
    const real p_sec = real(2) * xm * sr;
    const real q_sec = real(1) - sr;
    const real q_i = fa / fc_safe;
    const real r_i = fb / fc_safe;
    const real p_iqi = sr * (real(2) * xm * q_i * (q_i - r_i) - (b - a) * (r_i - real(1)));
    const real q_iqi = (q_i - real(1)) * (r_i - real(1)) * (sr - real(1));
    real pp = secant ? p_sec : p_iqi;
    real qq = secant ? q_sec : q_iqi;
    qq = pp > real(0) ? -qq : qq;
    pp = fabs_(pp);
    const real q_safe = fabs_(qq) > real(0) ? qq : tiny;
    const bool accept = can_interp && real(2) * pp < minf(real(3) * xm * qq - fabs_(tol1 * qq),
                                                          fabs_(e * qq));
    const real e_new = accept ? d : xm;
    const real d_new = accept ? pp / q_safe : xm;
    a = b;
    fa = fb;
    const real step = fabs_(d_new) > tol1 ? d_new : (xm >= real(0) ? tol1 : -tol1);
    b = b + step;
    fb = logLdivN(P, s, b) - target;
    d = d_new;
    e = e_new;
  }
  return fabs_(fb) <= fabs_(fc) ? b : c;
}

// ---------------------------------------------------------------------------
// ops/m2.py and ops/ice_nucleation.py pieces on the cloud PSD
// ---------------------------------------------------------------------------

struct CloudPDF {
  real logN0c, lam_c;
};

// ops/m2.py:pdf_cloud_parameters (log_pdf_cloud_parameters_mass inside)
__device__ __forceinline__ CloudPDF pdf_cloud(const scalar* __restrict__ P, real q,
                                              real rho, real N) {
  const real em = PV(EM), en = PV(EN);
  const real safe_q = maxf(q, em);
  const real safe_N = maxf(N, en);
  const real L = rho * safe_q;
  const real log_xbar = log_(L / safe_N);
  real logB = PV(CPDF_NEG_MU) * (log_xbar + PV(CPDF_LG1) - PV(CPDF_LG2));
  real logA = log_(PV(CPDF_MU)) + log_(safe_N) + PV(CPDF_Z1) * logB - PV(CPDF_LG1);
  const bool cond = N < en || q < em;
  logA = cond ? -r_inf() : logA;
  logB = cond ? r_inf() : logB;
  CloudPDF c;
  c.logN0c = logA + log_(real(3)) + PV(CPDF_NU1) * log_(PV(CPDF_KM));
  c.lam_c = exp_(logB) * PV(CPDF_KM_POW_MU);
  return c;
}

// ops/m2.py:size_distribution_cloud at D
__device__ __forceinline__ real n_cloud(const scalar* __restrict__ P, const CloudPDF& c,
                                        real D) {
  const real D_safe = maxf(D, PV(TINY));
  const real lam_safe = isinf_(c.lam_c) ? real(0) : c.lam_c;
  const real v = exp_(c.logN0c + PV(CPDF_NUD) * log_(D_safe) -
                      lam_safe * tpow(D_safe, PV(CPDF_MUD)));
  return (isinf_(c.logN0c) && c.logN0c < real(0)) ? real(0) : v;
}

// ops/p3_processes.py:compute_local_rime_density's Cober & List law at Ri
__device__ __forceinline__ real rho_rim_local(const scalar* __restrict__ P, real Ri) {
  Ri = clampf(Ri, real(1), real(12));
  const real cl93 = PV(RRL_B) * Ri + PV(RRL_A) + PV(RRL_C) * (Ri * Ri);
  const real f = (Ri - real(8)) * real(0.25);
  const real ext = (real(1) - f) * PV(RRL_RHO8) + f * PV(RRL_RHO_ICE);
  return Ri <= real(8) ? cl93 : ext;
}

// ops/thermo.py:saturation_vapor_pressure_over_ice
__device__ __forceinline__ real p_sat_ice(const scalar* __restrict__ P, real T) {
  return PV(PRESS_TRIPLE) * exp_(PV(KV_I) * log_(T * PV(INV_T_TRIPLE)) +
                                 PV(CL_I) * (PV(INV_T_TRIPLE) - real(1) / T));
}

// ops/ice_nucleation.py:INP_concentration_mean
__device__ __forceinline__ real inp_mean(const scalar* __restrict__ P, real T) {
  const real T_c = minf(T - PV(F23_T_FREEZE), real(0));
  const real arg = maxf(PV(F23_NEG_B) * T_c * PV(INV_TEN), PV(TINY));
  return real(9) * log_(arg) - PV(F23_LOG_A);
}


// ---------------------------------------------------------------------------
// The step's three kernels
// ---------------------------------------------------------------------------

struct Fields {
  const real* in[kFields];
  real* out[kFields];
  const real* guess;  // nullptr: cold start
  real* loglam;
};

// ---- K5a: shape solve, sanitized state, bounds, cloud window -------------
// (with K5_TEND: no solve; log lambda is read from f.loglam)

__global__ void __launch_bounds__(kSolveThreads, kSolveMinBlocks)
#ifdef K5_TEND
column_p3_bounds_kernel(Fields f, const scalar* __restrict__ P, real* __restrict__ scr,
                        int64_t ncells)
#else
column_p3_solve_kernel(Fields f, const scalar* __restrict__ P, real* __restrict__ scr,
                       int64_t ncells)
#endif
{
  // The cloud window's two inverse incomplete gammas take only parameters:
  // the block's first thread evaluates them before its own cell, and every
  // thread reads them after a barrier that it reaches after its shape solve.
  __shared__ real cloud_x[2];
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
  const real em = PV(EM), en = PV(EN), tiny = PV(TINY);
#ifdef K5_TEND
  // bulk_tendencies_2m hands p3_step_aux the clamped rho
  const real x_rho = maxf(f.in[0][i], real(0));
#else
  const real x_rho = f.in[0][i];
#endif
  const real x_q_ice = f.in[7][i], x_n_ice = f.in[8][i];
  const real x_q_rim = f.in[9][i], x_b_rim = f.in[10][i];

#ifdef K5_TEND
  const real loglam = f.loglam[i];
#else
  // shape solve on the raw state (models/column.py)
  const P3S raw = state_from_prognostic(P, x_q_ice * x_rho, x_n_ice * x_rho,
                                        x_q_rim * x_rho, x_b_rim * x_rho);
  const bool warm_start = f.guess != nullptr;
  const real loglam = shape_solve(P, raw, warm_start, warm_start ? f.guess[i] : real(0));
#endif

  // p3_step_aux: the sanitized state and its bounds
  const real q_ice = maxf(x_q_ice, real(0));
  const real n_ice = maxf(x_n_ice, real(0));
  const real L_ice = q_ice * x_rho, N_ice = n_ice * x_rho;
  const real L_rim = maxf(x_q_rim, real(0)) * x_rho, B_rim = maxf(x_b_rim, real(0)) * x_rho;
  const bool has_ice = q_ice > em && n_ice > en;
  const P3S s = state_from_prognostic(P, has_ice ? L_ice : real(1e-6),
                                      has_ice ? N_ice : real(1e3), has_ice ? L_rim : real(0),
                                      has_ice ? B_rim : real(0));
  const real ll = (has_ice && isfinite_(loglam)) ? loglam : real(8);
  const real mu = get_mu(P, ll);
  const real lam = exp_(ll);
  const real k1 = mu + real(0) + real(1);
  const real D_min = gamma_inc_inv4(P, k1, PV(IB_P_LO), PV(IB_Q_LO)) / lam;
  const real D_max = gamma_inc_inv4(P, k1, PV(IB_P_HI), PV(IB_Q_HI)) / lam;
  const real log_N0 = log_(maxf(s.N, tiny)) - loggamma_moment(mu, ll);

  // the cloud PSD's tail-quantile window of the collision integral
  const real rho = maxf(x_rho, real(0));
  const real L_lcl = maxf(f.in[3][i], real(0)) * rho, N_lcl = maxf(f.in[4][i], real(0)) * rho;
  const CloudPDF cp = pdf_cloud(P, L_lcl / rho, rho, N_lcl);
  const bool bad = isinf_(cp.lam_c) || cp.lam_c <= real(0);
  const real lam_safe = bad ? real(1) : cp.lam_c;
  __syncthreads();
  const real c_lo = tpow(cloud_x[0] / lam_safe, PV(CB_INV_MU));
  const real c_hi = tpow(cloud_x[1] / lam_safe, PV(CB_INV_MU));
  if (!active) return;

#ifndef K5_TEND
  f.loglam[i] = loglam;
#endif
  real* __restrict__ o = scr + i;
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
  o[S_C_LO * ncells] = bad ? real(0) : c_lo;
  o[S_C_HI * ncells] = bad ? real(0) : c_hi;
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
  const real L_rai = maxf(f.in[5][i], real(0)) * rho, N_rai = maxf(f.in[6][i], real(0)) * rho;
  const RainPDFT<real> rp = pdf_rain<kIceRainLimited, kIceRainPDF>(P, L_rai / rho, rho, N_rai);
  const real Dm_safe = rp.Dr_mean > real(0) ? rp.Dr_mean : real(1);
  const bool zero = rp.Dr_mean == real(0);
  const real r_lo = zero ? real(0) : -Dm_safe * PV(LOG1P_NEG_P);
  const real r_hi = zero ? real(0) : -Dm_safe * PV(LOG1P_NEG_1MP);
  const bool rain_valid = rp.N0 > real(0) && r_hi > r_lo;
  o[S_RAIN_OK * ncells] = rain_valid ? real(1) : real(0);
  o[S_R_LO * ncells] = rain_valid ? r_lo : real(1);
  o[S_R_HI * ncells] = rain_valid ? r_hi : real(2);
  o[S_R_N0 * ncells] = rp.N0;
  o[S_R_DM * ncells] = Dm_safe;
  const ChenRainT<real> cr = chen_rain_coeffs<kIceChen>(P, rho);
  o[S_CR_A0 * ncells] = cr.a[0];
  o[S_CR_A1 * ncells] = cr.a[1];
  o[S_CR_A2 * ncells] = cr.a[2];
  o[S_CR_B0 * ncells] = cr.b[0];
  o[S_CR_B1 * ncells] = cr.b[1];
  o[S_CR_B2 * ncells] = cr.b[2];
  const real T = f.in[1][i];
  const real Lv = PV(LH_V0) + PV(DCP_VL) * (T - PV(T_0));
  const real T_c = T - PV(P3_T_FREEZE);
  const real Lf = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const real e_si = p_sat_ice(P, T);
  const real dT = PV(T_FRZ) - T;
  const real drho_v_sat = rho * (rdiv(PV(E_SI_FRZ), rho * PV(R_V) * PV(T_FRZ)) -
                                 e_si / (rho * PV(R_V) * T));
  o[S_INV_2TC * ncells] =
      rdiv(real(1e6), real(2) * (fabs_(T_c) > real(0) ? T_c : -PV(EPS_MACH)));
  o[S_FRZ_DEN * ncells] = Lf - PV(CP_L) * dT;
  o[S_FRZ_NUM * ncells] = PV(K_THERM) * dT + Lv * PV(D_VAPOR) * drho_v_sat;
}

// ---- K5b: the ice node pass ----------------------------------------------

// Per-node addends of one chunk that K5b writes to shared memory: the ten
// collision sums, melt and the two fall-speed sums (all nodes, scratch order
// S_QCFRZ .. S_VM), the six segment moments (nw, nw r, nw r^2 and each
// times v), the triangle and the cross-segment addends, and r and v for the
// cross-segment blocks.
enum Addend {
  A_QCFRZ, A_QCSHD, A_NCCOL, A_QRFRZ, A_QRSHD, A_NRCOL, A_INT_M, A_BCCOL, A_BRCOL,
  A_INT_WET, A_MELT, A_VN, A_VM,
  A_M0, A_TRI = A_M0 + 6, A_CROSS, A_R, A_V,
  kAddends
};
constexpr int kAllNodeSums = A_M0;  // sums over every node of the cell
// serial sums per cell but the cross-segment ones: those over every node,
// six moments and the triangle per segment
constexpr int kTasks = kAllNodeSums + 6 * kSegments + kSegments;

template <int N>
struct NodePass {
  static constexpr int NN = kSegments * N;                     // ice nodes of a cell
  static constexpr int G = (NN <= 32 && 32 % NN == 0) ? NN : 32;  // lanes per cell
  // ice nodes a lane evaluates per chunk: two at float32 (GL-16's 64 nodes
  // are then one chunk), one at float64 (shared memory), none past the last
  static constexpr int PER_MAX = kF64 ? 1 : 2;
  static constexpr int PER = (NN + G - 1) / G < PER_MAX ? (NN + G - 1) / G : PER_MAX;
  static constexpr int CH = PER * G;                           // nodes per chunk
  static constexpr int CHUNKS = (NN + CH - 1) / CH;
  // lane passes of the last chunk: those that hold a node
  static constexpr int LAST_PER = (NN - (CHUNKS - 1) * CH + G - 1) / G;
  static constexpr int PASSES = (CHUNKS - 1) * PER + LAST_PER;  // lane passes a cell
  static constexpr int CELLS = kNodeThreads / G;               // cells per block
  // blocks per SM the registers are held to: float32 at 128 registers, 4
  // (a cap of 64, 8 blocks, made GL-16's K5b slower on an H100), float64
  // at 255, 2
  static constexpr int MIN_BLOCKS = kF64 ? 2 : 4;
  static constexpr int NL = Orders<N>::NL;
  static constexpr int LC = NL < kMaxLiq ? NL : kMaxLiq;       // liquid nodes held at once
  static constexpr int LCHUNKS = (NL + LC - 1) / LC;
};

// Lane passes of the chunk from node g0: PER, but LAST_PER in the last
// chunk; the constant PER where the last chunk's nodes need every pass
template <int N>
__device__ __forceinline__ int chunk_passes(int g0) {
  using L = NodePass<N>;
  if constexpr (L::LAST_PER == L::PER) {
    return L::PER;
  } else {
    return g0 + L::CH < L::NN ? L::PER : L::LAST_PER;
  }
}

// The running serial sums of tasks 0 .. kTasks - 1 and the cross sums,
// carried from chunk to chunk: none with one chunk
template <int N, bool RUN = (NodePass<N>::CHUNKS > 1)>
struct NodeRun {
  real run[kTasks + kSegments];
};
template <int N>
struct NodeRun<N, false> {};

// Aligned to 16 bytes, so that each cell's rows are, and the compiler
// loads a liquid node row's factors four at a time (a 4-byte misalignment
// made GL-16's K5b markedly slower on an H100).
template <int N>
struct alignas(16) NodeShared : NodeRun<N> {
  real add[kAddends][NodePass<N>::CH];  // the chunk's addends, by node
  real liq[8][NodePass<N>::LC];  // cloud D, v, nw, nw m; rain D, v, nw, nw m
  real seg[6][kSegments];        // each segment's six moments
  real pre[kSegments][6];        // the moments of the segments below each one
  real cross[kSegments], tri[kSegments];
};

// acc + row[a] + row[a + 1] + ... + row[b - 1], one term at a time, as
// utils/quadrature.sum_nodes adds a node axis; LEN > 0 sums row[0 .. LEN)
// (a and b unread), a trip count the compiler knows
template <int LEN>
__device__ __forceinline__ real serial_add(real acc, const real* row, int a, int b) {
  const int first = LEN > 0 ? 0 : a, last = LEN > 0 ? LEN : b;
#pragma unroll 4
  for (int i = first; i < last; ++i) {
    K5_COUNT(R_SUM_IT, 4);
    acc = acc + row[i];
  }
  return acc;
}

// Serial sum `slot` over one addend row's nodes [first, first + LEN) (row
// holds the chunk from node g0): with one chunk the whole sum; else this
// chunk's part added to the running sum in sh.run. True, with the sum in
// `sum`, once the sum is final.
template <int N, int LEN>
__device__ __forceinline__ bool task_sum(NodeShared<N>& sh, int slot, const real* row,
                                         int first, int g0, real& sum) {
  using L = NodePass<N>;
  if constexpr (L::CHUNKS == 1) {
    sum = serial_add<LEN>(real(0), row + first, 0, 0);
    return true;
  } else {
    const int last = first + LEN;
    const int a = first > g0 ? first : g0, b = last < g0 + L::CH ? last : g0 + L::CH;
    if (b <= a) return false;  // none of its nodes in this chunk
    const real acc = a == first ? real(0) : sh.run[slot];
    sum = b - a == L::CH ? serial_add<L::CH>(acc, row, 0, 0)
                         : serial_add<0>(acc, row, a - g0, b - g0);
    if (b < last) {
      sh.run[slot] = sum;
      return false;
    }
    return true;
  }
}

// The liquid node factors of the collision integral for liquid nodes
// [l0, l0 + n) (n = min(LC, NL - l0)), into sh.liq: two lanes per node, lane
// t < 2 n the fall speed of node t, lane 2 n + t its PSD weights (t < n:
// cloud node t; t >= n: rain node t - n)
template <int N>
__device__ __forceinline__ void liquid_factors(const scalar* __restrict__ P,
                                               const real* __restrict__ rec, int64_t ncells,
                                               NodeShared<N>& sh, int lane, int l0) {
  using O = Orders<N>;
  using L = NodePass<N>;
  constexpr int NL = O::NL, LC = L::LC, G = L::G;
  const scalar* __restrict__ TAB = P + N_PARAMS;
  const int n = NL - l0 < LC ? NL - l0 : LC;
  auto factor = [&](const int t) {
    K5_COUNT(R_LIQ);
    const bool speed = t < 2 * n;
    const int k = speed ? t : t - 2 * n;
    const bool cloud = k < n;
    const int j = cloud ? k : k - n;
    const int l = l0 + j;
    const real lo = rec[(cloud ? S_C_LO : S_R_LO) * ncells];
    const real hi = rec[(cloud ? S_C_HI : S_R_HI) * ncells];
    const bool valid = lo < hi;
    const real a_s = valid ? lo : real(1), b_s = valid ? hi : real(2);
    const real scale = (b_s - a_s) * real(0.5), mid = (a_s + b_s) * real(0.5);
    const real D = scale * ldp(TAB + O::Y_LIQ + l) + mid;
    real* __restrict__ liq = &sh.liq[cloud ? 0 : 4][0];
    if (speed) {
      const real log_D = log_(D);
      liq[j] = D;
      liq[LC + j] = rec[S_CR_A0 * ncells] * exp_(rec[S_CR_B0 * ncells] * log_D -
                                                 ldp(P + P_CH_C1U + kIceChen) * D) +
                    rec[S_CR_A1 * ncells] * exp_(rec[S_CR_B1 * ncells] * log_D -
                                                 ldp(P + P_CH_C2U + kIceChen) * D) +
                    rec[S_CR_A2 * ncells] * exp_(rec[S_CR_B2 * ncells] * log_D -
                                                 ldp(P + P_CH_C3U + kIceChen) * D);
    } else {
      const real wl = ldp(TAB + O::W_LIQ + l) * scale;
      real nw;
      if (cloud) {
        CloudPDF cp;
        cp.logN0c = rec[S_CP_LOGN0 * ncells];
        cp.lam_c = rec[S_CP_LAM * ncells];
        nw = n_cloud(P, cp, D) * (valid ? wl : real(0));
      } else {
        const real N0 = rec[S_R_N0 * ncells];
        const real nr = N0 * exp_(-D / rec[S_R_DM * ncells]);
        nw = (N0 == real(0) ? real(0) : nr) * (valid ? wl : real(0));
      }
      liq[2 * LC + j] = nw;
      liq[3 * LC + j] = nw * (PV(RHO_W) * (D * D * D * PV(PI_F) * sixth<real>()));
    }
  };
  // a lane per factor where they fit in one pass (the loop's form cost
  // GL-16's K5b registers and time on an H100)
  if (4 * LC <= G) {
    if (lane < 4 * n) factor(lane);
  } else {
#pragma unroll 1
    for (int t = lane; t < 4 * n; t += G) factor(t);
  }
}

template <int N>
__global__ void __launch_bounds__(kNodeThreads, NodePass<N>::MIN_BLOCKS)
column_p3_nodes_kernel(Fields f, const scalar* __restrict__ P, real* __restrict__ scr,
#ifdef K5_TEND
                       unsigned long long* __restrict__ ran,
#endif
                       int64_t ncells) {
  using O = Orders<N>;
  using L = NodePass<N>;
  constexpr int NL = O::NL, G = L::G, NN = L::NN, CH = L::CH, LC = L::LC;
  __shared__ NodeShared<N> smem[L::CELLS];
  K5_COUNT(R_NODE_LANE);
  const scalar* __restrict__ TAB = P + N_PARAMS;
  const int lane = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int64_t cell = (int64_t)blockIdx.x * L::CELLS + slot;
  const bool active = cell < ncells;
  // a slot past the last cell repeats the last cell and stores nothing, so
  // that every lane of the warp reaches each __syncwarp
  const int64_t c = active ? cell : ncells - 1;
#if defined(K5_TEND) && !defined(K5_TEND_NO_SKIP)
  {
    // The rates kernel keeps a cell's node sums only where it holds ice,
    // by this test on the same inputs, and discards them by select
    // elsewhere: a warp none of whose cells holds ice does no node work
    // and writes nothing. The decision is the warp's, so every lane of a
    // warp that runs reaches each __syncwarp. The block adds its cells
    // whose node pass runs to *ran, once. (-DK5_TEND_NO_SKIP leaves the
    // skip and its count out, so that a test can hold the rest of this
    // K5b to the column build's, instruction for instruction.)
    const real q_ice = f.in[7][c], n_ice = f.in[8][c];
    const bool has_ice = maxf(q_ice, real(0)) > PV(EM) && maxf(n_ice, real(0)) > PV(EN);
    const bool run = __any_sync(0xffffffffu, has_ice);
    const int runs = __syncthreads_count(run && active && lane == 0);
    if (threadIdx.x == 0 && runs > 0) atomicAdd(ran, (unsigned long long)runs);
    if (!run) return;
  }
#endif
  NodeShared<N>& sh = smem[slot];
  const real tiny = PV(TINY);
  const real* __restrict__ rec = scr + c;

  const real T = f.in[1][c];
  P3S s;
  s.L = rec[S_L * ncells];
  s.N = rec[S_N * ncells];
  s.F = rec[S_F * ncells];
  s.rho_rim = rec[S_RHO_RIM * ncells];
  s.rho_g = rec[S_RHO_G * ncells];
  s.D_th = PV(D_TH);
  s.D_gr = rec[S_D_GR * ncells];
  s.D_cr = rec[S_D_CR * ncells];
  const real mu = rec[S_MU * ncells];
  const real lam = rec[S_LAM * ncells];
  const real log_N0 = rec[S_LOG_N0 * ncells];
  IceVel vc;
  vc.as0 = rec[S_VC_AS0 * ncells];
  vc.as1 = rec[S_VC_AS1 * ncells];
  vc.bs = rec[S_VC_BS * ncells];
  vc.al0 = rec[S_VC_AL0 * ncells];
  vc.al1 = rec[S_VC_AL1 * ncells];
  const bool rain_valid = rec[S_RAIN_OK * ncells] != real(0);
  const real inv_2Tc = rec[S_INV_2TC * ncells];
  const real frz_num = rec[S_FRZ_NUM * ncells], frz_denom = rec[S_FRZ_DEN * ncells];
  const real log_tiny = log_(tiny);

  if (L::LCHUNKS == 1) {
    liquid_factors<N>(P, rec, ncells, sh, lane, 0);
    __syncwarp();
  }

  // One chunk of CH nodes from node g0: each lane's PER nodes, then every
  // sum over them. A single chunk (every order up to 16 at float32) runs
  // with g0 = 0 known, so its sums' bounds are constants.
  auto chunk = [&](const int g0) {
    // ---- each lane's nodes: node g = g0 + p G + lane is node j of segment
    // sg, in each pass that holds a node (a lane past the last node
    // evaluates the last node; nothing reads it)
    const int passes = chunk_passes<N>(g0);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      K5_COUNT(R_NODE);
      const int q = p * G + lane;            // the node's place in the chunk
      const int ge = NN % CH == 0 || g0 + q < NN ? g0 + q : NN - 1;
      const int sg = ge / N, j = ge - sg * N;
      const real lo = rec[(S_B0 + sg) * ncells], hi = rec[(S_B0 + sg + 1) * ncells];
      const bool valid = lo < hi;
      const real a_s = valid ? lo : real(1), b_s = valid ? hi : real(2);
      const real scale = (b_s - a_s) * real(0.5), mid = (a_s + b_s) * real(0.5);
      const bool tail = sg == kSegments - 1;
      const int n_in = tail ? O::NT : O::NI;
      const int y_in = tail ? O::Y_TAIL : O::Y_IN;
      const int w_in = tail ? O::W_TAIL : O::W_IN;
      const real D = scale * ldp(TAB + O::Y_ICE + j) + mid;
      const real wj = valid ? ldp(TAB + O::W_ICE + j) * scale : real(0);
      const IceParticle ip = ice_particle(P, s, vc, D);
      const real v = ip.v;
      // log_(maxf(D, tiny)): the particle's log_(D) unless D < tiny
      const real n = exp_(log_N0 + mu * (D < tiny ? log_tiny : ip.log_D) - lam * D);
      const real nw = n * wj;
      const real r = sqrt_(ip.area * PV(INV_PI));

      // -- liquid x ice collisions at this node, over every liquid node in
      // order (the factors of at most kMaxLiq liquid nodes at a time)
      const real k0 = PV(PI_F) * (r * r), k1 = PV(PI_F) * r;
      real dN_c = real(0), dM_c = real(0), dB_c = real(0);
      real dN_r = real(0), dM_r = real(0), dB_r = real(0);
#pragma unroll
      for (int lc = 0; lc < L::LCHUNKS; ++lc) {
        if (L::LCHUNKS > 1) {
          __syncwarp();
          liquid_factors<N>(P, rec, ncells, sh, lane, lc * LC);
          __syncwarp();
        }
#pragma unroll
        for (int l = 0; l < LC; ++l) {
          if (lc * LC + l < NL) {
            const real Dl = sh.liq[0][l];
            const real K = (PV(K2) * Dl + k1) * Dl + k0;
            const real v_rel = fabs_(v - sh.liq[1][l]);
            const real dV = K * v_rel;
            const real t1 = dV * sh.liq[2][l];
            const real t2 = dV * sh.liq[3][l];
            const real t3 = t2 / rho_rim_local(P, Dl * v_rel * inv_2Tc);
            const bool first = lc * LC + l == 0;
            dN_c = first ? t1 : dN_c + t1;
            dM_c = first ? t2 : dM_c + t2;
            dB_c = first ? t3 : dB_c + t3;
          }
        }
#pragma unroll
        for (int l = 0; l < LC; ++l) {
          if (lc * LC + l < NL) {
            const real Dl = sh.liq[4][l];
            const real K = (PV(K2) * Dl + k1) * Dl + k0;
            const real v_rel = fabs_(v - sh.liq[5][l]);
            const real dV = K * v_rel;
            const real t1 = dV * sh.liq[6][l];
            const real t2 = dV * sh.liq[7][l];
            const real t3 = t2 / rho_rim_local(P, Dl * v_rel * inv_2Tc);
            const bool first = lc * LC + l == 0;
            dN_r = first ? t1 : dN_r + t1;
            dM_r = first ? t2 : dM_r + t2;
            dB_r = first ? t3 : dB_r + t3;
          }
        }
      }
      if (!(isfinite_(dN_r) && isfinite_(dM_r)) || !rain_valid) {
        dN_r = real(0);
        dM_r = real(0);
        dB_r = real(0);
      }
      const real dM_col = dM_c + dM_r;
      const real F_v = PV(P3_VENT_A) + PV(P3_VENT_BC) * sqrt_(D * v * PV(INV_NU_AIR));
      real frz = real(2) * (PV(PI_F) * D) * F_v * frz_num /
                 (frz_denom > real(0) ? frz_denom : real(1));
      frz = frz_denom > real(0) ? frz : PV(BIG);
      frz = T >= PV(T_FRZ) ? real(0) : frz;
      const real dM_frz = minf(dM_col, frz);
      const bool zero_col = dM_col == real(0);
      const real f_frz = zero_col ? real(0) : dM_frz / (zero_col ? real(1) : dM_col);
      const real wet = dM_col > dM_frz ? real(1) : real(0);
      sh.add[A_QCFRZ][q] = nw * (dM_c * f_frz);
      sh.add[A_QCSHD][q] = nw * (dM_c * (real(1) - f_frz));
      sh.add[A_NCCOL][q] = nw * dN_c;
      sh.add[A_QRFRZ][q] = nw * (dM_r * f_frz);
      sh.add[A_QRSHD][q] = nw * (dM_r * (real(1) - f_frz));
      sh.add[A_NRCOL][q] = nw * dN_r;
      sh.add[A_INT_M][q] = nw * dM_col;
      sh.add[A_BCCOL][q] = nw * (dB_c * f_frz);
      sh.add[A_BRCOL][q] = nw * (dB_r * f_frz);
      sh.add[A_INT_WET][q] = nw * (wet * dM_col);

      // -- melt and the weighted fall speeds
      const MassCoeffs mc = mass_coeffs(P, s, D);
      sh.add[A_MELT][q] = mc.a * mc.b * pow_(D, mc.b - real(1)) * F_v * nw / D;
      sh.add[A_VN][q] = nw * v;
      sh.add[A_VM][q] = nw * v * ip.m;

      // -- self-collection: this segment's moments, r and v for the
      // cross-segment blocks
      const real nwr = nw * r, nwr2 = nwr * r;
      sh.add[A_M0][q] = nw;
      sh.add[A_M0 + 1][q] = nwr;
      sh.add[A_M0 + 2][q] = nwr2;
      sh.add[A_M0 + 3][q] = nw * v;
      sh.add[A_M0 + 4][q] = nwr * v;
      sh.add[A_M0 + 5][q] = nwr2 * v;
      sh.add[A_R][q] = r;
      sh.add[A_V][q] = v;

      // -- self-collection, within-segment triangle [a_seg, D]
      const real t_lo = lo + real(0);
      const bool t_valid = t_lo < D;
      const real ta = t_valid ? t_lo : real(1), tb = t_valid ? D : real(2);
      const real t_scale = (tb - ta) * real(0.5), t_mid = (ta + tb) * real(0.5);
      real tri = real(0);
#pragma unroll 1
      for (int i = 0; i < n_in; ++i) {
        K5_COUNT(R_TRI_IT);
        const real D2 = t_scale * ldp(TAB + y_in + i) + t_mid;
        const real w2 = t_valid ? ldp(TAB + w_in + i) * t_scale : real(0);
        const IceParticle ip2 = ice_particle(P, s, vc, D2);
        const real r2 = sqrt_(ip2.area * PV(INV_PI));
        const real K = PV(PI_F) * ((r + r2) * (r + r2));
        const real n2 = exp_(log_N0 + mu * (D2 < tiny ? log_tiny : ip2.log_D) - lam * D2);
        tri = tri + K * fabs_(v - ip2.v) * n2 * w2;
      }
      sh.add[A_TRI][q] = tri * nw;
    }
    __syncwarp();

    // ---- the serial sums over this chunk's nodes, one lane each; a sum is
    // final once its last node is in
#pragma unroll 1
    for (int t = lane; t < kTasks; t += G) {
      K5_COUNT(R_TASK);
      real sum;
      if (t < kAllNodeSums) {
        if (task_sum<N, NN>(sh, t, sh.add[t], 0, g0, sum) && active)
          scr[(S_QCFRZ + t) * ncells + cell] = sum;
      } else if (t < kAllNodeSums + 6 * kSegments) {
        const int m = (t - kAllNodeSums) % 6, sg = (t - kAllNodeSums) / 6;
        if (task_sum<N, N>(sh, t, sh.add[A_M0 + m], sg * N, g0, sum)) sh.seg[m][sg] = sum;
      } else {
        const int sg = t - kAllNodeSums - 6 * kSegments;
        if (task_sum<N, N>(sh, t, sh.add[A_TRI], sg * N, g0, sum)) sh.tri[sg] = sum;
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int m = lane; m < 6; m += G) {
      // the moments of the segments below each segment, added in segment
      // order once the segment below is complete
      K5_COUNT(R_PREFIX);
      if (g0 == 0) sh.pre[0][m] = real(0);
#pragma unroll
      for (int sb = 1; sb < kSegments; ++sb) {
        if (sb * N > g0 && sb * N <= g0 + CH)
          sh.pre[sb][m] = sh.pre[sb - 1][m] + sh.seg[m][sb - 1];
      }
    }
    __syncwarp();
    // cross-segment blocks against the segments below
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      const int q = p * G + lane;
      const int ge = NN % CH == 0 || g0 + q < NN ? g0 + q : NN - 1;
      const int sg = ge / N;
      if (sg > 0) {
        K5_COUNT(R_CROSS);
        const real* pre = sh.pre[sg];
        const real r = sh.add[A_R][q], v = sh.add[A_V][q], nw = sh.add[A_M0][q];
        const real ci = PV(PI_F) * (r * r * (v * pre[0] - pre[3]) +
                                    real(2) * r * (v * pre[1] - pre[4]) + (v * pre[2] - pre[5]));
        sh.add[A_CROSS][q] = ci * nw;
      }
    }
    __syncwarp();
    if (lane > 0 && lane < kSegments) {
      K5_COUNT(R_CROSS_SUM);
      real sum;
      if (task_sum<N, N>(sh, kTasks + lane, sh.add[A_CROSS], lane * N, g0, sum))
        sh.cross[lane] = sum;
    }
    __syncwarp();
  };
  if (L::CHUNKS == 1) {
    chunk(0);
  } else {
#pragma unroll 1
    for (int ch = 0; ch < L::CHUNKS; ++ch) chunk(ch * CH);
  }

  if (lane == 0 && active) {
    K5_COUNT(R_AGG);
    real agg = real(0);
#pragma unroll
    for (int sb = 1; sb < kSegments; ++sb) agg = agg + sh.cross[sb];
#pragma unroll
    for (int sb = 0; sb < kSegments; ++sb) agg = agg + sh.tri[sb];
    scr[S_AGG * ncells + cell] = agg;
  }
}

// ---- K5c: the rates, sedimentation and the update ------------------------

struct CellIn {
  real rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice, n_ice, q_rim, b_rim;
#ifdef K5_TEND
  real inpc_log_shift;  // added to the F23 INP log concentration
#endif
};

struct CellOut {
  real T_new;
  real dq_lcl, dn_lcl, dq_rai, dn_rai, dq_ice, dn_ice, dq_rim, db_rim;
  real F[kFluxes];  // downward fluxes: q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
};

template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_epilogue(const scalar* __restrict__ P,
                                                 const CellIn& x,
                                                 const real* __restrict__ rec,
                                                 int64_t ncells, real dt) {
  const real em = PV(EM), en = PV(EN), tiny = PV(TINY);
  CellOut o;

  // bulk_tendencies_2m clamps + the warm rates
  const real rho = maxf(x.rho, real(0));
  const real q_tot = maxf(x.q_tot, real(0));
  const real q_lcl = maxf(x.q_lcl, real(0));
  const real q_rai = maxf(x.q_rai, real(0));
  const real n_lcl = maxf(x.n_lcl, real(0));
  const real n_rai = maxf(x.n_rai, real(0));
  const real q_ice = maxf(x.q_ice, real(0));
  const real n_ice = maxf(x.n_ice, real(0));
  const WarmRatesT<real> w =
      warm_rates<LIMITED>(P, x.rho, x.T, x.q_tot, x.q_lcl, x.n_lcl, x.q_rai, x.n_rai, q_ice);
  const real T = x.T;
  const real N_lcl = n_lcl * rho, N_rai = n_rai * rho;
  const bool has_ice = q_ice > em && n_ice > en;

  // the solve's sanitized state and the node pass's sums
  const real s_L = rec[S_L * ncells], s_N = rec[S_N * ncells];
  const real s_F = rec[S_F * ncells], s_rho_rim = rec[S_RHO_RIM * ncells];
  const real QCFRZ = rec[S_QCFRZ * ncells], QCSHD = rec[S_QCSHD * ncells];
  const real NCCOL = rec[S_NCCOL * ncells], QRFRZ = rec[S_QRFRZ * ncells];
  const real QRSHD = rec[S_QRSHD * ncells], NRCOL = rec[S_NRCOL * ncells];
  const real INT_M = rec[S_INT_M * ncells], BCCOL = rec[S_BCCOL * ncells];
  const real BRCOL = rec[S_BRCOL * ncells], INT_WET = rec[S_INT_WET * ncells];
  const real acc_melt = rec[S_MELT * ncells], acc_vn = rec[S_VN * ncells];
  const real acc_vm = rec[S_VM * ncells], agg = rec[S_AGG * ncells];
  const real Lf = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const real e_si = p_sat_ice(P, T);

  // collision sources (ops/p3_processes.py)
  const bool zero_int = INT_M == real(0);
  const real f_wet = zero_int ? real(0) : INT_WET / (zero_int ? real(1) : INT_M);
  const real NRSHD = QRSHD * PV(INV_M_SHD);
  const bool has_rim = s_rho_rim > real(0);
  const real rr_safe = has_rim ? s_rho_rim : real(1);
  const real B_rim_c = has_rim ? s_L * s_F / rr_safe : real(0);
  const real QIWET = f_wet * s_L * (real(1) - s_F) * PV(INV_TAU_WET);
  const real BIWET = f_wet * (s_L * PV(INV_RHO_I) - B_rim_c) * PV(INV_TAU_WET);
  const real c_dq_c = (-QCFRZ - QCSHD) / rho;
  const real c_dq_r = (-QRFRZ + QCSHD) / rho;
  const real c_dN_c = -NCCOL;
  const real c_dN_r = -NRCOL + NRSHD;
  const real c_dL_rim = QCFRZ + QRFRZ + QIWET;
  const real c_dL_ice = QCFRZ + QRFRZ;
  const real c_dB_rim = BCCOL + BRCOL + BIWET;

  // ice_tendencies_2m_p3 (models/p3_tendencies.py)
  real dq_lcl = w.dq_lcl + (has_ice ? c_dq_c : real(0));
  real dq_rai = w.dq_rai + (has_ice ? c_dq_r : real(0));
  real dn_lcl = w.dn_lcl + (has_ice ? c_dN_c : real(0)) / rho;
  real dn_rai = w.dn_rai + (has_ice ? c_dN_r : real(0)) / rho;
  real dq_ice = real(0) + (has_ice ? c_dL_ice : real(0)) / rho;
  real dq_rim = real(0) + (has_ice ? c_dL_rim : real(0)) / rho;
  real db_rim = real(0) + (has_ice ? c_dB_rim : real(0)) / rho;
  real dn_ice = real(0) - (has_ice ? agg : real(0)) / rho;

  // melt (above freezing)
  {
    const real fac = rdiv(PV(FOUR_K_THERM), Lf) * (T - PV(P3_T_FREEZE));
    const real dLdt = maxf(fac * acc_melt, real(0));
    const real dNdt = s_N / maxf(s_L, tiny) * dLdt;
    const bool melting = has_ice && T > PV(T_FRZ);
    const real dq_m = (melting ? dLdt : real(0)) / rho;
    const real dn_m = (melting ? dNdt : real(0)) / rho;
    dq_rai = dq_rai + dq_m;
    dn_rai = dn_rai + dn_m;
    dq_ice = dq_ice - dq_m;
    dn_ice = dn_ice - dn_m;
    dq_rim = dq_rim - dq_m * s_F;
    db_rim = db_rim - (has_rim ? dq_m * s_F / rr_safe : real(0));
  }

  // F23 deposition nucleation and the F23-capped Bigg immersion freezing
  const real q_liq = q_lcl + q_rai;
  const real q_sat_ice = e_si / (rho * PV(R_V) * T);
  const real q_vap = maxf(q_tot - q_liq - q_ice, real(0));
#ifdef K5_TEND
  const real inpc_per_kg = exp_(inp_mean(P, T) + x.inpc_log_shift) / rho;
#else
  const real inpc_per_kg = exp_(inp_mean(P, T) + real(0)) / rho;
#endif
  {
    const real S_i = q_vap / q_sat_ice - real(1);
    const bool cond = T < PV(F23_T_THRESH) && S_i > PV(S_I_THRESH);
    real dn = maxf(inpc_per_kg - n_ice, real(0)) * PV(INV_TAU_ACT);
    dn = cond ? dn : real(0);
    const real q_excess = maxf(q_vap - q_sat_ice, real(0));
    const real dq = minf(PV(M_NUC) * dn, q_excess * PV(INV_2TAU_ACT));
    dn_ice = dn_ice + dn;
    dq_ice = dq_ice + dq;
  }
  {
    const real n = N_lcl / rho;
    const CloudPDF cp = pdf_cloud(P, q_lcl, rho, N_lcl);
    const bool ok = isfinite_(cp.lam_c) && cp.lam_c > real(0);
    const real lam_safe = ok ? cp.lam_c : real(1);
    const real J = PV(HET_B) * exp_(PV(HET_A) * (PV(T_FRZ) - T));
    const real M3 = ok ? n * tpow(lam_safe, PV(GGM_E3)) * PV(GGM_R3) : real(0);
    const real M6 = ok ? n * tpow(lam_safe, PV(GGM_E6)) * PV(GGM_R6) : real(0);
    const bool cond = n > en && q_lcl > em && T < PV(T_FRZ_M4);
    const real cld_n = cond ? J * PV(V1) * M3 : real(0);
    const real cld_q = cond ? J * PV(RHO_W) * PV(V1SQ) * M6 : real(0);
    real cap = maxf(inpc_per_kg - n_ice, real(0)) * PV(INV_TAU_ACT);
    cap = T >= PV(F23_T_FREEZE) ? real(0) : cap;
    const real dn_imm = minf(cld_n, cap);
    const bool freezing = cld_n > real(0);
    const real dq_imm = freezing ? cld_q * dn_imm / (freezing ? cld_n : real(1)) : real(0);
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
    const real n_per_q = some_ice ? n_ice / (some_ice ? q_ice : real(1)) : real(0);
    const real Ls = PV(LH_S0) + PV(DCP_VI) * (T - PV(T_0));
    const real cp_air = PV(CP_D) + PV(CPVD) * q_tot + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
    const real dqdT = q_sat_ice * (Ls / (PV(R_V) * (T * T)) - real(1) / T);
    const real ts = PV(TAU_SD) * (real(1) + (Ls / cp_air) * dqdT);
    const real sat = q_vap - q_sat_ice;
    real dq_dep = sat < real(0) ? -minf(-sat, maxf(q_ice, real(0))) / ts : sat / ts;
    dq_dep = T > PV(T_FRZ) ? minf(dq_dep, real(0)) : dq_dep;
    const real dn_dep = dq_dep < real(0) ? n_per_q * dq_dep : real(0);
    dq_ice = dq_ice + dq_dep;
    dn_ice = dn_ice + dn_dep;
    const real dq_sub = minf(dq_dep, real(0));
    dq_rim = dq_rim + dq_sub * s_F;
    db_rim = db_rim + (has_rim ? dq_sub * s_F / rr_safe : real(0));
  }

  // ice number adjustment (mass limits)
  {
    const real n_tgt =
        q_ice < em ? real(0) : clampf(n_ice, q_ice * PV(INV_XI_MAX), q_ice * PV(INV_XI_MIN));
    dn_ice = dn_ice + (n_tgt - n_ice) * PV(INV_TAU_NI);
  }

  // Bigg rain freezing (fully rimed)
  {
    const real n = N_rai / rho;
    const real Dr_mean = pdf_rain<kIceRainLimited, kIceRainPDF>(P, q_rai, rho, N_rai).Dr_mean;
    const bool pos = Dr_mean > real(0);
    const real Dm = pos ? Dr_mean : real(1);
    const real J = PV(HET_B) * exp_(PV(HET_A) * (PV(T_FRZ) - T));
    const real M3 = pos ? n * real(6) * (Dm * Dm * Dm) : real(0);
    const real M6 = pos ? n * real(720) * pow_(Dm, real(6)) : real(0);
    const bool cond = n > en && q_rai > em && T < PV(T_FRZ_M4);
    const real rf_n = cond ? J * PV(V1) * M3 : real(0);
    const real rf_q = cond ? J * PV(IR_RHO_W) * PV(V1SQ) * M6 : real(0);
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
  const RainSpeedsT<real> rs = rain_fall_speeds<LIMITED, CHEN>(P, x.rho, x.q_rai, x.n_rai);
  const bool v_empty = s_N < PV(EPS_MACH) || s_L < PV(EPS_MACH);
  const real vt_n_ice = v_empty ? real(0) : acc_vn / maxf(s_N, tiny);
  const real vt_m_ice = v_empty ? real(0) : acc_vm / maxf(s_L, tiny);
  o.F[0] = x.rho * rs.vt_m * x.q_rai;
  o.F[1] = x.rho * rs.vt_n * x.n_rai;
  o.F[2] = x.rho * vt_m_ice * x.q_ice;
  o.F[3] = x.rho * vt_n_ice * x.n_ice;
  o.F[4] = x.rho * vt_m_ice * x.q_rim;
  o.F[5] = x.rho * vt_m_ice * x.b_rim;

  // latent heating, unclamped state
  const real Lf_T = PV(LH_F0) + PV(CPLI) * (T - PV(T_0));
  const real cp = PV(CP_D) + PV(CPVD) * x.q_tot + PV(CPLV) * (x.q_lcl + x.q_rai) +
                  PV(CPIV) * x.q_ice;
  o.T_new = T + dt * (w.Lv * (dq_lcl + dq_rai + dq_ice) + Lf_T * dq_ice) / cp;
  return o;
}

// One chunk of levels [k_lo, k_hi) of a block's columns, a thread per
// (column, level), the level index fastest: the cell updates, their fluxes
// through shared memory, and the fluxes of level k_lo into `carry`, the
// inflow of the next chunk down (when there is one: k_lo > 0, the same for
// every thread of the block). `carry` holds the inflow into level k_hi - 1
// (0 above the column).
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ void epilogue_chunk(const Fields& f, const scalar* __restrict__ P,
                                               const real* __restrict__ scr, int64_t ncells,
                                               int nlev, int64_t col, bool in_col, int t,
                                               int lc, int chunk, int k_lo, int k_hi,
                                               real dt, real dz,
                                               real (&flux)[kFluxes][kEpiThreads],
                                               real (&carry)[kFluxes]) {
  const int k = k_lo + (t - lc * chunk);
  const bool active = in_col && k < k_hi;
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
  const bool more = k_lo > 0;
  real below[kFluxes];
  if (more) {
#pragma unroll
    for (int i = 0; i < kFluxes; ++i) below[i] = flux[i][lc * chunk];
  }
  if (active) {
    K5_COUNT(R_EPI_OUT);
    const bool top = k == k_hi - 1;
    const real rho_dz = x.rho * dz;
    real sed[kFluxes];
#pragma unroll
    for (int i = 0; i < kFluxes; ++i)
      sed[i] = ((top ? carry[i] : flux[i][t + 1]) - o.F[i]) / rho_dz;
    // sed: q_rai, n_rai, q_ice, n_ice, q_rim, b_rim
    f.out[0][idx] = x.rho;
    f.out[1][idx] = o.T_new;
    f.out[2][idx] = maxf(x.q_tot + dt * (sed[0] + sed[2]), real(0));
    f.out[3][idx] = maxf(x.q_lcl + dt * o.dq_lcl, real(0));
    f.out[4][idx] = maxf(x.n_lcl + dt * o.dn_lcl, real(0));
    f.out[5][idx] = maxf(x.q_rai + dt * (o.dq_rai + sed[0]), real(0));
    f.out[6][idx] = maxf(x.n_rai + dt * (o.dn_rai + sed[1]), real(0));
    const real q_ice_new = maxf(x.q_ice + dt * (o.dq_ice + sed[2]), real(0));
    const real q_rim_new = maxf(x.q_rim + dt * (o.dq_rim + sed[4]), real(0));
    f.out[7][idx] = q_ice_new;
    f.out[8][idx] = maxf(x.n_ice + dt * (o.dn_ice + sed[3]), real(0));
    f.out[9][idx] = minf(q_rim_new, q_ice_new);
    f.out[10][idx] = maxf(x.b_rim + dt * (o.db_rim + sed[5]), real(0));
  }
  if (more) {
#pragma unroll
    for (int i = 0; i < kFluxes; ++i) carry[i] = below[i];
    __syncthreads();
  }
}

// A block steps `cols` whole columns, a thread per (column, level of a
// chunk), the level index fastest; blockDim.x == cols * chunk <= kEpiThreads.
// Each column's levels run from the top in chunks of `chunk` levels (the
// bottom one ragged); the fluxes into a chunk's top level are the fluxes of
// the level above it, carried from the chunk before (0 above the column).
// The warm rain's options (LIMITED: the SB2006 rain PSD limiters; CHEN: Chen
// 2022 rain fall speeds) are compile-time variants, picked at launch, and so
// is TALL: columns of more than one chunk (chunk < nlev), a kernel apart so
// that the one-chunk kernel's registers are its own.
template <bool LIMITED, bool CHEN, bool TALL>
__global__ void __launch_bounds__(kEpiThreads, kEpiMinBlocks)
column_p3_epilogue_kernel(Fields f, const scalar* __restrict__ P,
                          const real* __restrict__ scr, int ncol, int nlev, int cols,
                          int chunk, real dt, real dz) {
  __shared__ real flux[kFluxes][kEpiThreads];
  const int t = threadIdx.x;
  const int lc = t / chunk;
  const int64_t col = (int64_t)blockIdx.x * cols + lc;
  const bool in_col = lc < cols && col < ncol;
  const int64_t ncells = (int64_t)ncol * nlev;
  real carry[kFluxes];  // the fluxes of the level above the chunk
#pragma unroll
  for (int i = 0; i < kFluxes; ++i) carry[i] = real(0);
  if (TALL) {
#pragma unroll 1
    for (int k_hi = nlev; k_hi > 0; k_hi -= chunk)
      epilogue_chunk<LIMITED, CHEN>(f, P, scr, ncells, nlev, col, in_col, t, lc, chunk,
                                    k_hi > chunk ? k_hi - chunk : 0, k_hi, dt, dz, flux,
                                    carry);
  } else {
    epilogue_chunk<LIMITED, CHEN>(f, P, scr, ncells, nlev, col, in_col, t, lc, nlev, 0,
                                  nlev, dt, dz, flux, carry);
  }
}

Fields make_fields(const scalar* const* in, scalar* const* out, const scalar* guess,
                   scalar* loglam) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = reinterpret_cast<const real*>(in[i]);
    f.out[i] = out ? reinterpret_cast<real*>(out[i]) : nullptr;
  }
  f.guess = reinterpret_cast<const real*>(guess);
  f.loglam = reinterpret_cast<real*>(loglam);
  return f;
}

template <bool LIMITED, bool CHEN>
int launch_epilogue(const Fields& f, const scalar* params, const real* scratch, int ncol,
                    int nlev, int cols, int chunk, int grid, scalar dt, scalar dz,
                    cudaStream_t s) {
  if (chunk < nlev)
    column_p3_epilogue_kernel<LIMITED, CHEN, true><<<grid, cols * chunk, 0, s>>>(
        f, params, scratch, ncol, nlev, cols, chunk, real(dt), real(dz));
  else
    column_p3_epilogue_kernel<LIMITED, CHEN, false><<<grid, cols * chunk, 0, s>>>(
        f, params, scratch, ncol, nlev, cols, chunk, real(dt), real(dz));
  return (int)cudaGetLastError();
}

#ifdef K5_TEND
// ---- K5c with K5_TEND: the point-wise rates ------------------------------

// The rates a point writes, in Tendencies2M's order: dq_lcl, dn_lcl, dq_rai,
// dn_rai, dq_ice, dn_ice, dq_rim, db_rim
constexpr int kRates = 8;

// A thread a point of the flat grid: K5c's rates of the point (no fluxes,
// no update), with the point's INP log shift (none given: 0).
template <bool LIMITED, bool CHEN>
__global__ void __launch_bounds__(kEpiThreads, kEpiMinBlocks)
column_p3_tend_rates_kernel(Fields f, const real* __restrict__ shift,
                            const scalar* __restrict__ P, const real* __restrict__ scr,
                            int64_t ncells) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ncells) return;
  K5_COUNT(R_TEND);
  CellIn x;
  x.rho = f.in[0][i];
  x.T = f.in[1][i];
  x.q_tot = f.in[2][i];
  x.q_lcl = f.in[3][i];
  x.n_lcl = f.in[4][i];
  x.q_rai = f.in[5][i];
  x.n_rai = f.in[6][i];
  x.q_ice = f.in[7][i];
  x.n_ice = f.in[8][i];
  x.q_rim = f.in[9][i];
  x.b_rim = f.in[10][i];
  x.inpc_log_shift = shift != nullptr ? shift[i] : real(0);
  const CellOut o = cell_epilogue<LIMITED, CHEN>(P, x, scr + i, ncells, real(0));
  f.out[0][i] = o.dq_lcl;
  f.out[1][i] = o.dn_lcl;
  f.out[2][i] = o.dq_rai;
  f.out[3][i] = o.dn_rai;
  f.out[4][i] = o.dq_ice;
  f.out[5][i] = o.dn_ice;
  f.out[6][i] = o.dq_rim;
  f.out[7][i] = o.db_rim;
}

template <bool LIMITED, bool CHEN>
int launch_tend_rates(const Fields& f, const real* shift, const scalar* params,
                      const real* scratch, int64_t ncells, int grid, cudaStream_t s) {
  column_p3_tend_rates_kernel<LIMITED, CHEN><<<grid, kEpiThreads, 0, s>>>(
      f, shift, params, scratch, ncells);
  return (int)cudaGetLastError();
}
#endif

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

// The build's variant: bytes of its scalar type, quadrature order, slope
// law (1: SlopeConstant), aspect ratio (1: Oblate), ice rain PSD limiters
int column_p3_variant(int* out) {
  out[0] = (int)sizeof(scalar);
  out[1] = kOrder;
  out[2] = kSlopeConstant ? 1 : 0;
  out[3] = kOblate ? 1 : 0;
  out[4] = kIceRainLimited ? 1 : 0;
  return 0;
}

// threads per block of K5a, K5b and (at most) K5c
int column_p3_threads(int kernel) {
  switch (kernel) {
    case 0: return kSolveThreads;
    case 1: return kNodeThreads;
    case 2: return kEpiThreads;
    default: return 0;
  }
}

// lanes per cell of K5b
int column_p3_lanes_per_cell() { return NodePass<kOrder>::G; }

// K5b's ice nodes per chunk of a cell, and its chunks.
int column_p3_node_chunk() { return NodePass<kOrder>::CH; }
int column_p3_node_chunks() { return NodePass<kOrder>::CHUNKS; }
// K5b's lane passes a cell: over its chunks, the passes that hold a node.
int column_p3_node_passes() { return NodePass<kOrder>::PASSES; }

// Length of the node/weight tables behind the scalar parameters.
int column_p3_table_len() { return Orders<kOrder>::LEN; }

// Registers, local memory bytes, static shared memory bytes and the largest
// block of kernel 0 (K5a), 1 (K5b) or 2 (K5c, limited rain PSD, SB2006 rain
// fall speeds, one chunk of levels: the variant of the default parameters;
// with K5_TEND the rates kernel of that variant).
int column_p3_kernel_attrs(int kernel, int* out) {
  switch (kernel) {
#ifdef K5_TEND
    case 0: return attrs(column_p3_bounds_kernel, out);
    case 1: return attrs(column_p3_nodes_kernel<kOrder>, out);
    case 2: return attrs(column_p3_tend_rates_kernel<true, false>, out);
#else
    case 0: return attrs(column_p3_solve_kernel, out);
    case 1: return attrs(column_p3_nodes_kernel<kOrder>, out);
    case 2: return attrs(column_p3_epilogue_kernel<true, false, false>, out);
#endif
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef K5_TEND
// K5a with K5_TEND: the scratch record's first rows from eleven (ncells)
// inputs in ColumnStateP3 order and the input log lambda; `grid` blocks of
// kSolveThreads.
int column_p3_tend_bounds(const scalar* const* in, const scalar* loglam, scalar* scratch,
                          const scalar* params, long long ncells, int grid, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f = make_fields(in, nullptr, nullptr, const_cast<scalar*>(loglam));
  column_p3_bounds_kernel<<<grid, kSolveThreads, 0, (cudaStream_t)stream>>>(
      f, params, reinterpret_cast<real*>(scratch), ncells);
  return (int)cudaGetLastError();
}

// K5c with K5_TEND: the eight rates (kRates outputs) from the inputs, the
// INP log shift (null: none) and the scratch record; `grid` blocks of
// kEpiThreads, a thread a point.
int column_p3_tend_rates(const scalar* const* in, const scalar* shift, scalar* const* out,
                         const scalar* scratch, const scalar* params, long long ncells,
                         int grid, int limited, int chen, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Fields f = make_fields(in, nullptr, nullptr, nullptr);
  for (int k = 0; k < kRates; ++k) f.out[k] = reinterpret_cast<real*>(out[k]);
  const real* s = reinterpret_cast<const real*>(shift);
  const real* scr = reinterpret_cast<const real*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  if (limited)
    return chen ? launch_tend_rates<true, true>(f, s, params, scr, ncells, grid, st)
                : launch_tend_rates<true, false>(f, s, params, scr, ncells, grid, st);
  return chen ? launch_tend_rates<false, true>(f, s, params, scr, ncells, grid, st)
              : launch_tend_rates<false, false>(f, s, params, scr, ncells, grid, st);
}

// the number of rates column_p3_tend_rates writes
int column_p3_tend_rates_count() { return kRates; }
#else
// K5a: eleven (ncol, nlev) inputs in ColumnStateP3 order, an optional
// warm-start guess (null for a cold start), the log lambda output and the
// (kScratch, ncells) scratch record; `grid` blocks of kSolveThreads.
int column_p3_solve(const scalar* const* in, const scalar* guess, scalar* loglam,
                    scalar* scratch, const scalar* params, long long ncells, int grid,
                    int device, void* stream) {
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f = make_fields(in, nullptr, guess, loglam);
  column_p3_solve_kernel<<<grid, kSolveThreads, 0, (cudaStream_t)stream>>>(
      f, params, reinterpret_cast<real*>(scratch), ncells);
  return (int)cudaGetLastError();
}
#endif

// K5b: the node pass over the scratch record; `grid` blocks of
// kNodeThreads, column_p3_lanes_per_cell() lanes per cell. With K5_TEND it
// adds the cells whose node pass ran to the device's int64 *ran.
int column_p3_nodes(const scalar* const* in, scalar* scratch, const scalar* params,
#ifdef K5_TEND
                    long long* ran,
#endif
                    long long ncells, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f = make_fields(in, nullptr, nullptr, nullptr);
  column_p3_nodes_kernel<kOrder><<<grid, kNodeThreads, 0, (cudaStream_t)stream>>>(
      f, params, reinterpret_cast<real*>(scratch),
#ifdef K5_TEND
      reinterpret_cast<unsigned long long*>(ran),
#endif
      ncells);
  return (int)cudaGetLastError();
}

#ifndef K5_TEND
// K5c: the eleven outputs from the inputs and the scratch record; `grid`
// blocks of `cols` whole columns walked in chunks of `chunk` levels
// (cols * chunk <= kEpiThreads threads, chunk <= nlev).
int column_p3_epilogue(const scalar* const* in, scalar* const* out, const scalar* scratch,
                       const scalar* params, int ncol, int nlev, int cols, int chunk,
                       int grid, scalar dt, scalar dz, int limited, int chen, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cols < 1 || chunk < 1 || chunk > nlev || cols * chunk > kEpiThreads)
    return (int)cudaErrorInvalidValue;
  const Fields f = make_fields(in, out, nullptr, nullptr);
  const real* scr = reinterpret_cast<const real*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  if (limited)
    return chen ? launch_epilogue<true, true>(f, params, scr, ncol, nlev, cols, chunk, grid,
                                              dt, dz, s)
                : launch_epilogue<true, false>(f, params, scr, ncol, nlev, cols, chunk, grid,
                                               dt, dz, s);
  return chen ? launch_epilogue<false, true>(f, params, scr, ncol, nlev, cols, chunk, grid, dt,
                                             dz, s)
              : launch_epilogue<false, false>(f, params, scr, ncol, nlev, cols, chunk, grid,
                                              dt, dz, s);
}
#endif

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
