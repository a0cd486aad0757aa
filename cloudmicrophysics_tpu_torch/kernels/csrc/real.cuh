// The scalar types of the column kernels and their math library calls.
//
// A float32 build computes on `float`, compiled with --fmad=false: each
// operation rounds on its own, as PyTorch's separate elementwise kernels
// do. A float64 build computes on `Dbl`, a double whose + - * / are the
// explicitly rounded __dadd_rn ... __ddiv_rn, which the compiler never
// contracts into an FMA, and is compiled with --fmad=true: the CUDA math
// library's double pow then rounds as in PyTorch's CUDA kernels (built with
// FMA contraction), which --fmad=false does not reproduce (measured on an
// H100: 5-61 of 4194304 pow results differ by an ULP), while the kernel's
// own arithmetic stays operation by operation.
//
// Each math name is one overload per type: for float the float function
// (expf, logf, ...), for Dbl the double one (exp, log, ...), the functions
// PyTorch's CUDA kernels call for a float32 or a float64 tensor. Cell code
// written on a scalar type R calls these, so one source serves both builds,
// and the float instantiation is the float code it was before.

#ifndef CMT_REAL_CUH
#define CMT_REAL_CUH

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace rmath {

// a double whose arithmetic is never contracted (see above); layout as a
// double, so a double buffer is read and written through it
struct Dbl {
  double v;
  Dbl() = default;
  __host__ __device__ constexpr Dbl(double x) : v(x) {}
};
__device__ __forceinline__ Dbl operator+(Dbl a, Dbl b) { return Dbl(__dadd_rn(a.v, b.v)); }
__device__ __forceinline__ Dbl operator-(Dbl a, Dbl b) { return Dbl(__dsub_rn(a.v, b.v)); }
__device__ __forceinline__ Dbl operator*(Dbl a, Dbl b) { return Dbl(__dmul_rn(a.v, b.v)); }
__device__ __forceinline__ Dbl operator/(Dbl a, Dbl b) { return Dbl(__ddiv_rn(a.v, b.v)); }
__device__ __forceinline__ Dbl operator-(Dbl a) { return Dbl(-a.v); }
__device__ __forceinline__ bool operator<(Dbl a, Dbl b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(Dbl a, Dbl b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(Dbl a, Dbl b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(Dbl a, Dbl b) { return a.v >= b.v; }
__device__ __forceinline__ bool operator==(Dbl a, Dbl b) { return a.v == b.v; }
__device__ __forceinline__ bool operator!=(Dbl a, Dbl b) { return a.v != b.v; }

// the type cell code computes on for a build's scalar type
template <typename S>
struct Real;
template <>
struct Real<float> {
  using type = float;
};
template <>
struct Real<double> {
  using type = Dbl;
};

__device__ __forceinline__ Dbl exp_(Dbl x) { return Dbl(exp(x.v)); }
__device__ __forceinline__ Dbl log_(Dbl x) { return Dbl(log(x.v)); }
__device__ __forceinline__ Dbl log1p_(Dbl x) { return Dbl(log1p(x.v)); }
__device__ __forceinline__ Dbl expm1_(Dbl x) { return Dbl(expm1(x.v)); }
__device__ __forceinline__ Dbl sqrt_(Dbl x) { return Dbl(sqrt(x.v)); }
__device__ __forceinline__ Dbl pow_(Dbl x, Dbl p) { return Dbl(pow(x.v, p.v)); }
__device__ __forceinline__ Dbl lgamma_(Dbl x) { return Dbl(lgamma(x.v)); }
__device__ __forceinline__ Dbl fabs_(Dbl x) { return Dbl(fabs(x.v)); }
__device__ __forceinline__ Dbl tanh_(Dbl x) { return Dbl(tanh(x.v)); }
__device__ __forceinline__ Dbl atanh_(Dbl x) { return Dbl(atanh(x.v)); }
__device__ __forceinline__ bool isnan_(Dbl x) { return isnan(x.v); }
__device__ __forceinline__ bool isinf_(Dbl x) { return isinf(x.v); }
__device__ __forceinline__ bool isfinite_(Dbl x) { return isfinite(x.v); }
__device__ __forceinline__ bool same_bits(Dbl a, Dbl b) {
  return __double_as_longlong(a.v) == __double_as_longlong(b.v);
}
// __shfl_sync of either type
__device__ __forceinline__ float shfl(float x, int lane) {
  return __shfl_sync(0xffffffffu, x, lane);
}
__device__ __forceinline__ Dbl shfl(Dbl x, int lane) {
  return Dbl(__shfl_sync(0xffffffffu, x.v, lane));
}

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ float expm1_(float x) { return expm1f(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float pow_(float x, float p) { return powf(x, p); }
__device__ __forceinline__ float lgamma_(float x) { return lgammaf(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ float atanh_(float x) { return atanhf(x); }
__device__ __forceinline__ bool isnan_(float x) { return isnan(x); }
__device__ __forceinline__ bool isinf_(float x) { return isinf(x); }
__device__ __forceinline__ bool isfinite_(float x) { return isfinite(x); }

// equal bit patterns (NaN and -0 included)
__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// the smallest normal number of each type (torch.finfo(dtype).tiny)
template <typename R>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float tiny = FLT_MIN;
};
template <>
struct Limits<double> {
  static constexpr double tiny = DBL_MIN;
};

}  // namespace rmath

#endif  // CMT_REAL_CUH
