// Fused 2-moment warm-rain column step (Seifert-Beheng 2006): one explicit
// Euler step of the warm-rain process rates, number- and mass-weighted rain
// sedimentation and the latent-heat temperature update, over (ncol, nlev)
// columns of (rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai), float32 or float64
// (the scalar type `real` of a build, K3_REAL of its generated header).
//
// Replaces the two Pallas TPU kernels of cloudmicrophysics_tpu/kernels/
// column2m.py: step_column_2m_pallas_packed (one (7, ncol, nlev) buffer in
// and out, optional q_tot affine on load) and step_column_2m_pallas (seven
// (ncol, nlev) buffers in and out). One __global__ body serves both; the
// two C entry points differ only in how they fill the field pointers.
//
// What bounds it on an H100: each cell reads 7 floats and writes 7 (56 B
// of HBM traffic) and evaluates a dozen exp/log/pow calls and about 35 IEEE
// divisions, 25 reciprocals and 10 square roots (an lgamma per Chen 2022
// term besides), all in their full-precision forms: its instruction
// stream, not HBM. Every intermediate stays in registers (one HBM read and
// one write per field), and the rain PSD is evaluated once where the eager
// step's two evaluations of it agree (warm2m.cuh:rain_pdfs).
//
// Rounding: built without fast math and with --fmad=false (float), or with
// --fmad=true over real.cuh's uncontracted Dbl (double), each expression
// follows the eager PyTorch step's operation order as PyTorch's CUDA
// kernels evaluate it, so that the kernel is bit-identical to its plain
// version: `x / c` for a Python-float c is a multiply by c's reciprocal,
// taken in double and rounded once to the build's type (the INV_*
// parameters, folded on the host), `c / x` is reciprocal(x) * c, and pow
// with exponent 2 or 3 is products.
//
// Parameters: the generated header defines each value of the parameter
// list as a literal of its exact value in the build's type (PC_<name>; a
// float64 build's block holds the float64 constants of its dtype), read through
// warm2m.cuh's literal accessor (WARM2M_LITERAL_PARAMS), and the options
// LIMITED (the SB2006 Eq 94-97 rain PSD limiters) and CHEN (Chen 2022 rain
// fall speeds instead of SB2006's Rogers-type fit) as K3_LIMITED and
// K3_CHEN: the library is built once per parameter block and variant, and
// holds that one variant. Every constant is an immediate operand (no
// global load, no register to hold it) and tpow's exponent branches are
// decided when the kernel is compiled.
//
// Layout: a block's `block_cols` columns are split into kWarps contiguous
// ranges of whole columns whose sizes differ by at most one (the first ranges
// the larger; a warp gets none when the block has fewer columns than warps).
// In the (ncol, nlev) layout a warp's range is one run of cols * nlev
// consecutive cells, which the warp steps in windows of 32 consecutive cells
// from the run's top down: lane l of a window owns one cell, so each field's
// load and store of a warp is 128 contiguous bytes, and only the window at
// the run's low end may be partial. A window may straddle columns, so no lane
// idles at the top of a column whose levels are not a multiple of 32 (at 100
// levels, 8 columns a warp fill 25 windows): the kernel is bound by its
// instruction stream, so a warp pays for its idle lanes. A lane's level k (its cell mod nlev) is kept
// in 32-bit arithmetic and stepped down by 32 mod nlev a window. The two rain
// fluxes of level k + 1, the next cell, come from the next lane by a shuffle;
// lane 31 takes lane 0's fluxes of the window above, carried from the
// previous iteration; a column's top level (k == nlev - 1) gets no inflow,
// whichever lane holds the next cell. No barrier: warps are independent, so
// nlev has no bound of the layout's own. Each warp's next window is copied
// into its own shared double buffer by cp.async while it steps the current
// one; a lane reads back only its own slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column2m_params.h"
#define WARM2M_LITERAL_PARAMS
#include "warm2m.cuh"

#ifdef K3_PROBE
#define STAGE_PROBE
#endif
#include "stage_probe.cuh"

namespace {

using namespace warm2m;

using scalar = K3_REAL;   // the build's dtype: float or double
using real = Real<scalar>::type;   // what the cells compute on (real.cuh)

// threads per block and resident blocks per SM the registers are held to:
// the fastest setting without spills of k1_occupancy_sweep.py k3 (PERF.md)
constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;
// a float64 build takes half the warps: its staging buffer holds twice the
// bytes per warp, and 16 warps' would pass the 48 KiB of static shared
// memory a block may have
constexpr int kBuildThreads = sizeof(scalar) == 4 ? kThreads : kThreads / 2;
constexpr int kWarps = kBuildThreads / 32;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai
constexpr bool kLimited = K3_LIMITED != 0;
constexpr bool kChen = K3_CHEN != 0;

struct Fields {
  const real* in[kFields];
  real* out[kFields];
};

struct CellOut {
  real T_new;
  real dq_lcl, dn_lcl, dq_rai, dn_rai;  // process-rate tendencies
  real F_q, F_n;                        // downward rain mass and number fluxes
};

// Everything of models/column.py:step_column_2m for one cell, except the
// flux exchange between levels. The warm-rain rates and fall speeds are the
// shared device code of warm2m.cuh (no ice: q_ice = 0), reading the
// parameters as literals, with the rain PSD evaluated once where the rates'
// and the fall speeds' agree (rain_pdfs).
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_step(real rho, real T, real q_tot,
                                             real q_lcl, real n_lcl,
                                             real q_rai, real n_rai,
                                             real dt) {
  RainPDFT<real> pdf_rates, pdf_speeds;
  rain_pdfs<LIMITED>(nullptr, rho, q_rai, n_rai, pdf_rates, pdf_speeds);
  const WarmRatesT<real> w = warm_rates<LIMITED>(nullptr, rho, T, q_tot, q_lcl,
                                                 n_lcl, q_rai, n_rai, real(0),
                                                 &pdf_rates);
  const RainSpeedsT<real> v =
      rain_fall_speeds<LIMITED, CHEN>(nullptr, rho, q_rai, n_rai, &pdf_speeds);
  CellOut o;
  o.dq_lcl = w.dq_lcl;
  o.dq_rai = w.dq_rai;
  o.dn_lcl = w.dn_lcl;
  o.dn_rai = w.dn_rai;
  o.F_q = rho * v.vt_m * q_rai;
  o.F_n = rho * v.vt_n * n_rai;

  // ---- latent heating: T-dependent Lv and moist cp, unclamped state ----
  const real cp = PV(CP_D) + PV(CPVD) * q_tot + PV(CPLV) * (q_lcl + q_rai);
  o.T_new = T + dt * w.Lv / cp * (o.dq_lcl + o.dq_rai);
  return o;
}

// Copy this lane's cell `cell` of one window (inactive: past the run's low
// end, at `lo`) of the seven fields into its slots of a shared buffer,
// asynchronously (cp.async, one group); an inactive lane's slots are filled
// with zeros.
__device__ __forceinline__ void fetch_window(const Fields& f, int64_t cell,
                                             int64_t lo, real (*buf)[32],
                                             int lane) {
  const bool active = cell >= lo;
  const int64_t idx = active ? cell : lo;
#pragma unroll
  for (int i = 0; i < kFields; ++i) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[i][lane]);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(f.in[i] + idx), "n"((int)sizeof(real)),
                 "r"(active ? (int)sizeof(real) : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool LIMITED, bool CHEN>
__global__ void __launch_bounds__(kBuildThreads, kMinBlocks)
column2m_step_kernel(const __grid_constant__ Fields f, int ncol, int nlev,
                     int block_cols, real dt, real dz, int has_affine,
                     real scale, real bias) {
  // per warp, two windows' fields: the one being stepped and the next
  __shared__ real stage[kWarps][2][kFields][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's range of the block's columns, as cells [lo, lo + len)
  const int first = blockIdx.x * block_cols;
  const int cols = block_cols < ncol - first ? block_cols : ncol - first;
  const int share = cols / kWarps, extra = cols % kWarps;
  const int64_t lo =
      (int64_t)(first + warp * share + (warp < extra ? warp : extra)) * nlev;
  const int64_t len = (int64_t)(share + (warp < extra)) * nlev;
  PROBE_START;

  // the top window: this lane's cell and its level, (lane - 32) mod nlev,
  // as the run is whole columns; each window down is 32 cells lower, and
  // its level 32 mod nlev lower, mod nlev (an integer division only where
  // nlev < 32)
  int64_t cell = lo + len - 32 + lane;
  const int k_step = nlev > 32 ? 32 : 32 % nlev;
  int k = (nlev > 32 ? lane : lane % nlev) - k_step;
  if (k < 0) k += nlev;
  int windows = (int)((len + 31) >> 5);
  int slot = 0;
  if (windows > 0) fetch_window(f, cell, lo, stage[warp][0], lane);
  // lane 31: lane 0's fluxes of the window above
  real carry_q = 0, carry_n = 0;
  for (; windows > 0; --windows) {
    PROBE_PASS;
    const bool active = cell >= lo;
    // the next window's copies are in flight while this one is stepped
    if (windows > 1)
      fetch_window(f, cell - 32, lo, stage[warp][slot ^ 1], lane);
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
    CellOut o = {};   // cells past the run's low end: zero flux
    if (active)
      o = cell_step<LIMITED, CHEN>(rho, q[1], q_tot, q[3], q[4], q[5], q[6], dt);
    PROBE_SINK(o.F_q + o.F_n + o.T_new + o.dq_lcl + o.dn_lcl + o.dq_rai + o.dn_rai);
    PROBE_STAGE(S_CELL);

    // inflow from level k + 1, the next cell: the next lane's fluxes, by a
    // rotation that hands lane 31 lane 0's, which lane 31 keeps for the
    // window below and takes from the window above; none at a column's top
    const int from = (lane + 1) & 31;
    real in_q = shfl(o.F_q, from);
    real in_n = shfl(o.F_n, from);
    if (lane == 31) {
      real t;
      t = in_q, in_q = carry_q, carry_q = t;
      t = in_n, in_n = carry_n, carry_n = t;
    }
    if (k == nlev - 1) in_q = in_n = real(0);
    PROBE_SINK(in_q + in_n + carry_q + carry_n);
    PROBE_STAGE(S_EXCHANGE);

    if (active) {
      const real rho_dz = rho * dz;
      const real sed_q = (in_q - o.F_q) / rho_dz;
      const real sed_n = (in_n - o.F_n) / rho_dz;
      f.out[0][cell] = rho;
      f.out[1][cell] = o.T_new;
      f.out[2][cell] = maxf(q_tot + dt * sed_q, real(0));
      f.out[3][cell] = maxf(q[3] + dt * o.dq_lcl, real(0));
      f.out[4][cell] = maxf(q[4] + dt * o.dn_lcl, real(0));
      f.out[5][cell] = maxf(q[5] + dt * (o.dq_rai + sed_q), real(0));
      f.out[6][cell] = maxf(q[6] + dt * (o.dn_rai + sed_n), real(0));
    }
    PROBE_STAGE(S_STORE);

    cell -= 32;
    k -= k_step;
    if (k < 0) k += nlev;
    slot ^= 1;
  }
  PROBE_END;
}

// the one variant this library holds
#define K3_KERNEL column2m_step_kernel<kLimited, kChen>

int launch(const Fields& f, int ncol, int nlev, int block_cols, real dt,
           real dz, int has_affine, real scale, real bias, int device,
           void* stream) {
  if (nlev < 1 || block_cols < 1 || ncol < 1) return (int)cudaErrorInvalidValue;
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (ncol + block_cols - 1) / block_cols;
  K3_KERNEL<<<grid, kBuildThreads, 0, (cudaStream_t)stream>>>(
      f, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column2m_threads_per_block() { return kBuildThreads; }

int column2m_num_params() { return N_PARAMS; }

// Bytes of the build's scalar type: 4 (float32) or 8 (float64).
int column2m_real_bytes() { return (int)sizeof(scalar); }

// The compiled variant: 2 * LIMITED + CHEN.
int column2m_variant() { return 2 * (int)kLimited + (int)kChen; }

// Blocks of the kernel resident on one SM, as the CUDA runtime computes them
// from its registers and shared memory.
int column2m_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, K3_KERNEL,
                                                        kBuildThreads, 0);
  return (int)err;
}

// Registers and local memory bytes per thread of the kernel.
int column2m_kernel_attrs(int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, K3_KERNEL);
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

// K4: seven (ncol, nlev) inputs and seven outputs, in ColumnState2M order.
int column2m_step_unpacked(const scalar* rho, const scalar* T, const scalar* q_tot,
                           const scalar* q_lcl, const scalar* n_lcl,
                           const scalar* q_rai, const scalar* n_rai,
                           scalar* rho_out, scalar* T_out, scalar* q_tot_out,
                           scalar* q_lcl_out, scalar* n_lcl_out,
                           scalar* q_rai_out, scalar* n_rai_out, int ncol, int nlev,
                           int block_cols, scalar dt, scalar dz, int has_affine,
                           scalar scale, scalar bias, int device, void* stream) {
  const scalar* in[kFields] = {rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai};
  scalar* out[kFields] = {rho_out, T_out, q_tot_out, q_lcl_out, n_lcl_out,
                          q_rai_out, n_rai_out};
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = reinterpret_cast<const real*>(in[i]);
    f.out[i] = reinterpret_cast<real*>(out[i]);
  }
  return launch(f, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias,
                device, stream);
}

// K3: one (7, ncol, nlev) input and output; field i starts at i * plane.
int column2m_step_packed(const scalar* in, scalar* out, long long plane, int ncol,
                         int nlev, int block_cols, scalar dt, scalar dz,
                         int has_affine, scalar scale, scalar bias, int device,
                         void* stream) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = reinterpret_cast<const real*>(in + i * plane);
    f.out[i] = reinterpret_cast<real*>(out + i * plane);
  }
  return launch(f, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias,
                device, stream);
}

#ifdef K3_PROBE
int column2m_probe_stages() { return S_COUNT; }

// The (S_COUNT + 1) unsigned 64-bit sums the next launches add to: the
// cycles of each stage, then the warp passes.
int column2m_probe_set(unsigned long long* sums, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stage_probe, &sums, sizeof(sums));
  return (int)err;
}
#endif

}  // extern "C"
