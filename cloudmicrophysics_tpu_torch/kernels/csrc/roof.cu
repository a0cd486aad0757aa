// The two measurements the column kernels are quoted against: the card's
// streaming copy roof and its rate of full-precision expf.
//
// copy_scale replaces the Pallas copy kernel of benchmarks/roofline.py
// (copy_kernel/copy_step, pallas_call at :124) and its two scratch copies,
// benchmarks/scratch/perf_roof.py:30 and perf_roof2.py:21: y = x * s + 1e-12
// over a float32 buffer, into a separate output. The TPU kernel tiles
// (7, 128, nlev) blocks to fit its VMEM; here the buffer is flat. A block of
// kCopyThreads threads walks it in a grid-stride loop of float4 loads and
// stores (16 bytes a thread, neighbouring threads on neighbouring addresses),
// with scalar head and tail loops for the elements before the first 16-byte
// boundary of x and after the last whole float4. Where x and y do not share
// their offset from a 16-byte boundary, every element takes the scalar loop.
// Bound by bytes: one read and one write of each element, nothing else. The
// grid covers the buffer, a float4 a thread (the loop comes round again
// only past the largest grid): a grid of one wave of resident blocks looping
// over the buffer ran 7 % below PyTorch's own elementwise pass, with one
// float4 a thread or four in flight alike (PERF.md).
//
// exp_chain is a probe of the card, not the port of a Pallas kernel (the JAX
// harness computes it in plain jnp, benchmarks/roofline.py:150): x <- x * s,
// then `chain` times x <- expf(-x), one thread per element with the chain in
// registers. Bound by the special-function units: each expf is one MUFU.EX2
// and a few float32 operations. Eager PyTorch would take 2 * chain passes
// over device memory; fused, the probe measures the rate of expf itself.
// The scale is a runtime argument that feeds the chain and every result is
// stored, so no step of the chain can be folded away at compile time.
//
// Rounding: the multiply and the add of copy_scale round separately
// (__fmul_rn, __fadd_rn), as the eager `x * s + 1e-12` does; expf is the
// full-precision one that PyTorch's CUDA exp calls. Built with --fmad=false
// and without fast math, like the column kernels, so that both kernels are
// bit-identical to their plain versions.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kExpThreads = 256;
// float32(1e-12), exactly (the constant the TPU kernel adds)
constexpr float kTiny = 0x1.197998p-40f;

__device__ __forceinline__ float scale_add(float x, float s) {
  return __fadd_rn(__fmul_rn(x, s), kTiny);
}

__global__ void __launch_bounds__(kCopyThreads)
copy_scale_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n, long long head, float s) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = (n - head) / 4;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ yv = reinterpret_cast<float4*>(y + head);
  for (long long i = tid; i < nvec; i += stride) {
    float4 v = xv[i];
    v.x = scale_add(v.x, s);
    v.y = scale_add(v.y, s);
    v.z = scale_add(v.z, s);
    v.w = scale_add(v.w, s);
    yv[i] = v;
  }
  for (long long i = tid; i < head; i += stride) y[i] = scale_add(x[i], s);
  for (long long i = head + 4 * nvec + tid; i < n; i += stride)
    y[i] = scale_add(x[i], s);
}

__global__ void __launch_bounds__(kExpThreads)
exp_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, float s, int chain) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = __fmul_rn(x[i], s);
  for (int c = 0; c < chain; ++c) v = expf(-v);
  y[i] = v;
}

}  // namespace

extern "C" {

int copy_scale_threads_per_block() { return kCopyThreads; }

int exp_chain_threads_per_block() { return kExpThreads; }

int copy_scale_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, copy_scale_kernel, kCopyThreads, 0);
  return (int)err;
}

int exp_chain_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, exp_chain_kernel, kExpThreads, 0);
  return (int)err;
}

int copy_scale_kernel_attrs(int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, copy_scale_kernel);
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

int exp_chain_kernel_attrs(int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, exp_chain_kernel);
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

// y[i] = x[i] * s + 1e-12 for i < n. x and y must not overlap. A thread per
// float4 (or per element, where every element takes the scalar loop).
int copy_scale(const float* x, float* y, long long n, float s, int device,
               void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // elements before x's first 16-byte boundary; all of them when y sits at
  // another offset from a boundary, so that no float4 access is misaligned
  const uintptr_t ax = (uintptr_t)x, ay = (uintptr_t)y;
  long long head = (long long)(((16 - (ax & 15)) & 15) / sizeof(float));
  if ((ax & 15) != (ay & 15) || head > n) head = n;
  const long long work = head == n ? n : (n - head + 3) / 4;
  long long grid = (work + kCopyThreads - 1) / kCopyThreads;
  if (grid > INT_MAX) grid = INT_MAX;
  copy_scale_kernel<<<(unsigned)grid, kCopyThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, head, s);
  return (int)cudaGetLastError();
}

// y[i] = the chain of x[i] * s through `chain` steps of expf(-v), i < n; a
// thread per element.
int exp_chain(const float* x, float* y, long long n, float s, int chain,
              int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + kExpThreads - 1) / kExpThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  exp_chain_kernel<<<(unsigned)grid, kExpThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, s, chain);
  return (int)cudaGetLastError();
}

}  // extern "C"
