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
#include "warm2m.cuh"

namespace {

using namespace warm2m;

constexpr int kThreads = 256;
constexpr int kFields = 7;  // rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai

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
// shared device code of warm2m.cuh (no ice: q_ice = 0).
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ CellOut cell_step(const float* __restrict__ P,
                                             float rho, float T, float q_tot,
                                             float q_lcl, float n_lcl,
                                             float q_rai, float n_rai,
                                             float dt) {
  const WarmRates w =
      warm_rates<LIMITED>(P, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, 0.0f);
  const RainSpeeds v = rain_fall_speeds<LIMITED, CHEN>(P, rho, q_rai, n_rai);
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
