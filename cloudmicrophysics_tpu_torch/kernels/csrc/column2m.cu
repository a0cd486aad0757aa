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
// of HBM traffic) and evaluates a dozen exp/log/pow calls and about 35 IEEE
// divisions, 25 reciprocals and 10 square roots (an lgamma per Chen 2022
// term besides), all in their full-precision forms: its instruction
// stream, not HBM. Every intermediate stays in registers (one HBM read and
// one write per field), and the rain PSD is evaluated once where the eager
// step's two evaluations of it agree (warm2m.cuh:rain_pdfs).
//
// Rounding: built with --fmad=false and without fast math, each expression
// follows the eager PyTorch step's operation order as PyTorch's CUDA
// kernels evaluate it, so that the kernel is bit-identical to its plain
// version: `x / c` for a Python-float c is a multiply by c's reciprocal,
// taken in double and rounded once to float (the INV_* parameters, folded
// on the host), `c / x` is reciprocal(x) * c, and pow with exponent 2 or 3
// is products.
//
// Parameters: the generated header defines each float of the parameter
// list as a float literal of its exact value (PC_<name>), read through
// warm2m.cuh's literal accessor (WARM2M_LITERAL_PARAMS), and the options
// LIMITED (the SB2006 Eq 94-97 rain PSD limiters) and CHEN (Chen 2022 rain
// fall speeds instead of SB2006's Rogers-type fit) as K3_LIMITED and
// K3_CHEN: the library is built once per parameter block and variant, and
// holds that one variant. Every constant is an immediate operand (no
// global load, no register to hold it) and tpow's exponent branches are
// decided when the kernel is compiled.
//
// Layout: a warp steps whole columns, 32 levels at a time from the top chunk
// down; lane l of chunk c owns level 32 c + l, so each field's load and store
// of a warp is 128 contiguous bytes. A block's kWarps warps share its
// `block_cols` columns (warp w takes columns w, w + kWarps, ...). The two
// rain fluxes of level k + 1 come from the next lane by a shuffle; lane 31
// takes lane 0's fluxes of the chunk above, carried from the previous
// iteration; the top level gets no inflow (levels above nlev carry zero
// flux). No barrier: warps are independent, so nlev has no bound of the
// layout's own. Each warp's next chunk is copied into its own shared double
// buffer by cp.async while it steps the current one; a lane reads back only
// its own slots.

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

// threads per block and resident blocks per SM the registers are held to:
// the fastest setting without spills of k1_occupancy_sweep.py k3 (PERF.md)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 1;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai
constexpr unsigned kFull = 0xffffffffu;
constexpr bool kLimited = K3_LIMITED != 0;
constexpr bool kChen = K3_CHEN != 0;

struct Fields {
  const float* in[kFields];
  float* out[kFields];
};

struct CellOut {
  float T_new;
  float dq_lcl, dn_lcl, dq_rai, dn_rai;  // process-rate tendencies
  float F_q, F_n;                        // downward rain mass and number fluxes
};

// Everything of models/column.py:step_column_2m for one cell, except the
// flux exchange between levels. The warm-rain rates and fall speeds are the
// shared device code of warm2m.cuh (no ice: q_ice = 0), reading the
// parameters as literals, with the rain PSD evaluated once where the rates'
// and the fall speeds' agree (rain_pdfs).
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_step(float rho, float T, float q_tot,
                                             float q_lcl, float n_lcl,
                                             float q_rai, float n_rai,
                                             float dt) {
  RainPDF pdf_rates, pdf_speeds;
  rain_pdfs<LIMITED>(nullptr, rho, q_rai, n_rai, pdf_rates, pdf_speeds);
  const WarmRates w = warm_rates<LIMITED>(nullptr, rho, T, q_tot, q_lcl, n_lcl,
                                          q_rai, n_rai, 0.0f, &pdf_rates);
  const RainSpeeds v =
      rain_fall_speeds<LIMITED, CHEN>(nullptr, rho, q_rai, n_rai, &pdf_speeds);
  CellOut o;
  o.dq_lcl = w.dq_lcl;
  o.dq_rai = w.dq_rai;
  o.dn_lcl = w.dn_lcl;
  o.dn_rai = w.dn_rai;
  o.F_q = rho * v.vt_m * q_rai;
  o.F_n = rho * v.vt_n * n_rai;

  // ---- latent heating: T-dependent Lv and moist cp, unclamped state ----
  const float cp = PV(CP_D) + PV(CPVD) * q_tot + PV(CPLV) * (q_lcl + q_rai);
  o.T_new = T + dt * w.Lv / cp * (o.dq_lcl + o.dq_rai);
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

template <bool LIMITED, bool CHEN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
column2m_step_kernel(const __grid_constant__ Fields f, int ncol, int nlev,
                     int block_cols, float dt, float dz, int has_affine,
                     float scale, float bias) {
  // per warp, two chunks' fields: the one being stepped and the next
  __shared__ float stage[kWarps][2][kFields][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = (nlev + 31) >> 5;
  const int block_end = (blockIdx.x + 1) * block_cols;
  const int end = block_end < ncol ? block_end : ncol;
  PROBE_START;

  // iteration (col, c): chunk c of column col, top chunk first
  int col = blockIdx.x * block_cols + warp;
  int c = nchunks - 1;
  int slot = 0;
  if (col < end) fetch_chunk(f, col, 32 * c + lane, nlev, stage[warp][0], lane);
  // lane 31: lane 0's fluxes of the chunk above; none above the top chunk
  float carry_q = 0.0f, carry_n = 0.0f;
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
      o = cell_step<LIMITED, CHEN>(rho, q[1], q_tot, q[3], q[4], q[5], q[6], dt);
    PROBE_SINK(o.F_q + o.F_n + o.T_new + o.dq_lcl + o.dn_lcl + o.dq_rai + o.dn_rai);
    PROBE_STAGE(S_CELL);

    // inflow from level k + 1: the next lane's fluxes, by a rotation that
    // hands lane 31 lane 0's, which lane 31 keeps for the chunk below and
    // takes from the chunk above
    const int from = (lane + 1) & 31;
    const bool bottom = c == 0;   // the next chunk starts a column's top
    float in_q = __shfl_sync(kFull, o.F_q, from);
    float in_n = __shfl_sync(kFull, o.F_n, from);
    if (lane == 31) {
      float t;
      t = in_q, in_q = carry_q, carry_q = bottom ? 0.0f : t;
      t = in_n, in_n = carry_n, carry_n = bottom ? 0.0f : t;
    }
    PROBE_SINK(in_q + in_n + carry_q + carry_n);
    PROBE_STAGE(S_EXCHANGE);

    if (active) {
      const int64_t idx = (int64_t)col * nlev + k;
      const float rho_dz = rho * dz;
      const float sed_q = (in_q - o.F_q) / rho_dz;
      const float sed_n = (in_n - o.F_n) / rho_dz;
      f.out[0][idx] = rho;
      f.out[1][idx] = o.T_new;
      f.out[2][idx] = maxf(q_tot + dt * sed_q, 0.0f);
      f.out[3][idx] = maxf(q[3] + dt * o.dq_lcl, 0.0f);
      f.out[4][idx] = maxf(q[4] + dt * o.dn_lcl, 0.0f);
      f.out[5][idx] = maxf(q[5] + dt * (o.dq_rai + sed_q), 0.0f);
      f.out[6][idx] = maxf(q[6] + dt * (o.dn_rai + sed_n), 0.0f);
    }
    PROBE_STAGE(S_STORE);

    col = next_col;
    c = next_c;
    slot ^= 1;
  }
  PROBE_END;
}

// the one variant this library holds
#define K3_KERNEL column2m_step_kernel<kLimited, kChen>

int launch(const Fields& f, int ncol, int nlev, int block_cols, float dt,
           float dz, int has_affine, float scale, float bias, int device,
           void* stream) {
  if (nlev < 1 || block_cols < 1 || ncol < 1) return (int)cudaErrorInvalidValue;
  // this library's CUDA runtime keeps its own current device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (ncol + block_cols - 1) / block_cols;
  K3_KERNEL<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      f, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int column2m_threads_per_block() { return kThreads; }

int column2m_num_params() { return N_PARAMS; }

// The compiled variant: 2 * LIMITED + CHEN.
int column2m_variant() { return 2 * (int)kLimited + (int)kChen; }

// Blocks of the kernel resident on one SM, as the CUDA runtime computes them
// from its registers and shared memory.
int column2m_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, K3_KERNEL,
                                                        kThreads, 0);
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
int column2m_step_unpacked(const float* rho, const float* T, const float* q_tot,
                           const float* q_lcl, const float* n_lcl,
                           const float* q_rai, const float* n_rai,
                           float* rho_out, float* T_out, float* q_tot_out,
                           float* q_lcl_out, float* n_lcl_out,
                           float* q_rai_out, float* n_rai_out, int ncol, int nlev,
                           int block_cols, float dt, float dz, int has_affine,
                           float scale, float bias, int device, void* stream) {
  Fields f = {{rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai},
              {rho_out, T_out, q_tot_out, q_lcl_out, n_lcl_out, q_rai_out,
               n_rai_out}};
  return launch(f, ncol, nlev, block_cols, dt, dz, has_affine, scale, bias,
                device, stream);
}

// K3: one (7, ncol, nlev) input and output; field i starts at i * plane.
int column2m_step_packed(const float* in, float* out, long long plane, int ncol,
                         int nlev, int block_cols, float dt, float dz,
                         int has_affine, float scale, float bias, int device,
                         void* stream) {
  Fields f;
  for (int i = 0; i < kFields; ++i) {
    f.in[i] = in + i * plane;
    f.out[i] = out + i * plane;
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
