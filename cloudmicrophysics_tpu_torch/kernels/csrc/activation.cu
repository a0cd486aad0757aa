// ARG2000 droplet activation (Abdul-Razzak and Ghan 2000) at every point of
// a state: the activated number of each aerosol mode
// (N_activated_per_mode) and its activated mass (M_activated_per_mode),
// each one launch over the points, float32 or float64 (ARG_REAL of the
// generated header).
//
// Replaces no TPU kernel: the JAX package's ARG2000
// (cloudmicrophysics_tpu/ops/aerosol_activation.py) is plain jnp, which XLA
// fuses. The port's eager version of it launches one PyTorch kernel per
// operation, about 480 full-size ones a call, each reading and writing
// whole temporaries of the state's shape: a host model that activates
// droplets at every grid point every step moved ~36 times the bytes the
// answers need, and outran CUDA's launch queue. These two kernels compute
// the same answers in one pass over each point's inputs.
//
// What bounds them on an H100: bytes at the least. The number kernel reads
// the air (T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice) and each mode's N,
// r_dry and species volume fractions, and writes one answer a mode: with
// MAM4's four modes and 21 species, 37 floats in and 4 out, 164 B a point.
// The mass kernel reads the species mass fractions besides, 58 in and 4
// out, 248 B a point. So each input is read once, straight into registers,
// coalesced across the warp (a lane a point), and nothing between goes to
// device memory; a mode's species fractions are folded into its
// hygroscopicity (and its mass) as they arrive. Every quantity the eager
// code computes more than once (the saturation vapour pressures, latent
// heats, the curvature coefficient, the critical supersaturations) is
// computed once. Their arithmetic, in full precision and uncontracted (14
// powf a point, 9 logf, 4 erff or erfcf, some 60 IEEE divisions), takes
// as long as their bytes or longer: so the launch's layout is compiled in
// (below) and every branch on it is decided when the kernel is built, the
// modes' loops unroll and their work interleaves.
//
// Layout (the generated header, from kernels/activation.py:Launch): the
// number of modes (ARG_MODES), each field's kind (ARG_KINDS): a Python
// number (its value in the parameter block, struct Params), a one-element
// tensor (a pointer that every point reads at 0) or a tensor of the
// state's shape (a pointer, a value a point); each mode's product pairs
// (volume fraction, kappa) of its hygroscopicity and (molar mass, mass
// fraction) of its mass (ARG_HYG_*, ARG_MASS_*); how each exponent is
// lowered (ARG_POW). The values, numbers and pointers, are the parameter
// block's, passed by value at each launch: one build serves every state of
// a layout.
//
// Rounding: built without fast math and with --fmad=false (float), or with
// --fmad=true over real.cuh's uncontracted Dbl (double), each expression
// follows the eager code's operation order as PyTorch's CUDA kernels
// evaluate it, so that the kernels are bit-identical to it: `x / c` for a
// Python number c is a multiply by c's reciprocal taken in double (the
// INV_* constants and a number's `inv`), `c / x` is reciprocal(x) * c,
// `x ** p` follows torch's lowering (products for 2 and 3, sqrt for 0.5,
// powf otherwise: pow_scalar), Python arithmetic on constants is folded on
// the host in double and rounded once, and the modes are summed in their
// order.

#include "real.cuh"
#include "activation_params.h"

namespace {

using namespace rmath;

typedef ARG_REAL scalar;
typedef Real<scalar>::type real;

constexpr int kThreads = 256;
constexpr int kModes = ARG_MODES;
constexpr int kFields = ARG_FIELDS;
constexpr int kAir = 8;          // T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice
constexpr int kModeFields = 5;   // N, r_dry, stdev, hygroscopicity, mass

enum Kind { NUMBER = 0, ONE = 1, POINT = 2 };
enum AirField { F_T, F_P, F_W, F_QT, F_QL, F_QI, F_NL, F_NI };
enum ModeField { M_N, M_RDRY, M_STDEV, M_HYG, M_MASS };
enum PowSlot { POW_CRIT, POW_P1, POW_P2, POW_THIRD };

// the layout, read at indices the unrolled loops make constants
__host__ __device__ constexpr int kind(int k) {
  constexpr int t[] = {ARG_KINDS};
  return t[k];
}
__host__ __device__ constexpr int hyg_first(int m) {
  constexpr int t[] = {ARG_HYG_FIRST};
  return t[m];
}
__host__ __device__ constexpr int hyg_count(int m) {
  constexpr int t[] = {ARG_HYG_COUNT};
  return t[m];
}
__host__ __device__ constexpr int mass_first(int m) {
  constexpr int t[] = {ARG_MASS_FIRST};
  return t[m];
}
__host__ __device__ constexpr int mass_count(int m) {
  constexpr int t[] = {ARG_MASS_COUNT};
  return t[m];
}
__host__ __device__ constexpr int pow_code(int slot) {
  constexpr int t[] = {ARG_POW};
  return t[slot];
}

struct Field {
  const scalar* ptr;  // a tensor's data (ONE, POINT)
  scalar val;         // a Python number's value (NUMBER)
  scalar inv;         // 1 / val in double, rounded: a division by the number
};

struct Params {
  Field f[kFields];   // air, then kModeFields a mode, then the pairs
  scalar c[N_PARAMS]; // constants folded on the host (P_<name>)
  long long n;        // points
  scalar* out;        // kModes rows of n points
};

__device__ __forceinline__ float erf_(float x) { return erff(x); }
__device__ __forceinline__ float erfc_(float x) { return erfcf(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ Dbl erf_(Dbl x) { return Dbl(erf(x.v)); }
__device__ __forceinline__ Dbl erfc_(Dbl x) { return Dbl(erfc(x.v)); }
__device__ __forceinline__ Dbl rsqrt_(Dbl x) { return Dbl(rsqrt(x.v)); }
__device__ __forceinline__ Dbl fmax_(Dbl a, Dbl b) { return Dbl(fmax(a.v, b.v)); }

// a value of the build's type as it is stored
__device__ __forceinline__ float raw(float x) { return x; }
__device__ __forceinline__ double raw(Dbl x) { return x.v; }

// Field k's value at point i.
__device__ __forceinline__ real get(const Params& P, int k, long long i) {
  if (kind(k) == NUMBER) return real(P.f[k].val);
  return real(__ldg(P.f[k].ptr + (kind(k) == POINT ? i : 0)));
}

// x / field k (whose value is v): a division by a tensor's value, a
// multiply by a Python number's reciprocal.
__device__ __forceinline__ real div_field(const Params& P, real x, int k,
                                          real v) {
  return kind(k) == NUMBER ? x * real(P.f[k].inv) : x / v;
}

// sum + a[0] * b[0] + a[1] * b[1] + ... over the `count` pairs of fields
// from `first`, at point i, in order.
__device__ __forceinline__ real fold(const Params& P, real sum, int first,
                                     int count, long long i) {
#pragma unroll
  for (int j = 0; j < count; ++j)
    sum = sum + get(P, first + 2 * j, i) * get(P, first + 2 * j + 1, i);
  return sum;
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ real clamp_min(real x, real lo) {
  return isnan_(x) ? x : fmax_(x, lo);
}

// x ** e as torch lowers a Python-number exponent (the code of
// kernels/activation.py:pow_code).
__device__ __forceinline__ real pow_scalar(real x, real e, int code) {
  switch (code) {
    case 1: return real(1);
    case 2: return x;
    case 3: return sqrt_(x);
    case 4: return rsqrt_(x);
    case 5: return real(1) / x;
    case 6: return x * x;
    case 7: return x * x * x;
    case 8: return real(1) / (x * x);
    default: return pow_(x, e);
  }
}

// _saturation_vapor_pressure: press_triple * exp(k1 log(T / T_triple)
// + k2 (1 / T_triple - 1 / T)), given log(T / T_triple) and 1 / T.
__device__ __forceinline__ real saturation_vapor_pressure(real log_t,
                                                          real inv_tt,
                                                          real inv_T, real k1,
                                                          real k2, real pt) {
  return exp_(log_t * k1 + (inv_tt - inv_T) * k2) * pt;
}

// G_func_liquid / G_func_ice at latent heat L and saturation pressure p_vs.
__device__ __forceinline__ real g_func(real T, real L, real p_vs, real eps_n,
                                       real inv_k, real inv_rv, real r_v,
                                       real inv_d) {
  const real ps = clamp_min(p_vs, eps_n);
  const real cond = ((L * inv_k) / T) * (((L * inv_rv) / T) - real(1));
  const real diff = ((T * r_v) * inv_d) / ps;
  return (real(1) / (cond + diff)) * real(1);
}

template <bool kMass>
__device__ __forceinline__ void arg2000(const Params& P) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P.n) return;
#define C(name) real(P.c[P_##name])
  const real T = get(P, F_T, i), p = get(P, F_P, i), w = get(P, F_W, i);
  const real q_tot = get(P, F_QT, i), q_liq = get(P, F_QL, i);
  const real q_ice = get(P, F_QI, i), N_liq = get(P, F_NL, i);
  const real N_ice = get(P, F_NI, i);

  // the curvature coefficient A (coeff_of_curvature), and 1 / T
  const real A = (real(1) / T) * C(CA);
  const real A3 = A * C(THIRD);
  const real inv_T = (real(1) / T) * real(1);

  // each mode's fields as they arrive: N, log(stdev), the critical
  // supersaturation (critical_supersaturation) from the hygroscopicity,
  // and the mass (M_activated_per_mode's M_i)
  real N[kModes], ls[kModes], Sm[kModes], Mi[kModes];
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const int base = kAir + kModeFields * m;
    N[m] = get(P, base + M_N, i);
    const real rd = get(P, base + M_RDRY, i);
    ls[m] = log_(get(P, base + M_STDEV, i));
    const real h = fold(P, get(P, base + M_HYG, i), hyg_first(m),
                        hyg_count(m), i);
    if (kMass)
      Mi[m] = fold(P, get(P, base + M_MASS, i), mass_first(m),
                   mass_count(m), i);
    Sm[m] = ((real(1) / sqrt_(h)) * real(2))
            * pow_scalar(div_field(P, A3, base + M_RDRY, rd), C(E_CRIT),
                         pow_code(POW_CRIT));
  }

  // max_supersaturation: the moist air
  const real eps = C(EPS);
  const real q_dry = (q_tot - q_liq) - q_ice;
  const real q_v = clamp_min(q_dry, real(0));
  const real R_m = ((real(1) - q_tot) + q_v * C(RV_RD)) * C(R_D);
  const real cpl_ql = kind(F_QL) == NUMBER ? C(CPLV_QL) : q_liq * C(CPLV);
  const real cpi_qi = kind(F_QI) == NUMBER ? C(CPIV_QI) : q_ice * C(CPIV);
  const real cp_m = ((q_tot * C(CPVD) + C(CP_D)) + cpl_ql) + cpi_qi;
  const real dT = T - C(T_0);
  const real Lv = dT * C(DCP_VL) + C(LH_V0);
  const real Ls = dT * C(DCP_VI) + C(LH_S0);
  const real rho_air = p / (R_m * T);
  const real p_v = ((q_dry * rho_air) * C(R_V)) * T;
  const real log_t = log_(T * C(INV_TT));
  const real p_vs = saturation_vapor_pressure(log_t, C(INV_TT), inv_T,
                                              C(KL1), C(KL2), C(PRESS_TRIPLE));
  const real p_vs_i = saturation_vapor_pressure(log_t, C(INV_TT), inv_T,
                                                C(KI1), C(KI2),
                                                C(PRESS_TRIPLE));
  const real G = g_func(T, Lv, p_vs, C(EPS_N), C(INV_K_THERM), C(INV_R_V),
                        C(R_V), C(INV_D_VAPOR)) * C(INV_RHO_W);

  const real pvr = p_v / p_vs;
  const real alpha =
      pvr * (((((Lv * C(G)) * C(INV_R_V)) / cp_m) / (T * T))
             - (((real(1) / R_m) * C(G)) / T));
  const real rvt = (T * C(R_V)) / p_vs;
  const real gamma =
      rvt + (((((pvr * R_m) * (Lv * Lv)) * C(INV_R_V)) / cp_m) / T) / p;

  const real aw = alpha * w;
  const real sqrt_awG = sqrt_(aw / G);
  const real zeta = ((A * real(2)) * C(THIRD)) * sqrt_awG;
  const real s3 = (sqrt_awG * sqrt_awG) * sqrt_awG;
  const real gce = gamma * C(CE);

  real tmp = real(0);
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const real f = exp_((ls[m] * ls[m]) * C(F2)) * C(F1);
    const real g = (ls[m] * C(G2)) + C(G1);
    const real eta = s3 / (gce * N[m]);
    const real Sm2 = Sm[m] * Sm[m];
    const real a = pow_scalar(zeta / eta, C(P1), pow_code(POW_P1)) * f;
    const real b = pow_scalar(Sm2 / (eta + zeta * real(3)), C(P2),
                              pow_code(POW_P2)) * g;
    tmp = tmp + ((real(1) / Sm2) * real(1)) * (a + b);
  }
  const real S_arg = (real(1) / sqrt_(tmp)) * real(1);

  // condensation sinks of the liquid and the ice already there
  const real r_liq =
      N_liq < eps ? real(0)
                  : pow_scalar(((((rho_air * q_liq) / clamp_min(N_liq, eps))
                                 * C(INV_RHO_W)) * C(INV_43PI)),
                               C(THIRD), pow_code(POW_THIRD));
  const real K_liq = (((N_liq * C(CKL)) * r_liq) * G) * gamma;
  const real gamma_i =
      rvt + ((((((pvr * R_m) * Lv) * Ls) * C(INV_R_V)) / cp_m) / T) / p;
  const real r_ice =
      N_ice < eps ? real(0)
                  : pow_scalar(((((rho_air * q_ice) / clamp_min(N_ice, eps))
                                 * C(INV_RHO_I)) * C(INV_43PI)),
                               C(THIRD), pow_code(POW_THIRD));
  const real rhoG_i = g_func(T, Ls, p_vs_i, C(EPS_N), C(INV_K_THERM),
                             C(INV_R_V), C(R_V), C(INV_D_VAPOR));
  const real xi = p_vs / p_vs_i;
  const real K_ice = (((N_ice * C(CKI)) * r_ice) * rhoG_i) * gamma_i;
  const real S_max = (S_arg * (aw - K_ice * (xi - real(1))))
                     / (aw + (K_liq + K_ice * xi) * S_arg);
  const real smax = clamp_min(clamp_min(S_max, real(0)),
                              real(Limits<scalar>::tiny));

  // each mode's activated number (erf) or mass (erfc)
  const real sqrt2 = sqrt_(real(2));
  scalar* out = P.out + i;
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    const real lr = log_(Sm[m] / smax);
    real a;
    if (kMass) {
      const real fac = ((ls[m] * real(3)) * sqrt2) * real(0.5);
      a = (Mi[m] * real(0.5)) * erfc_(lr / fac - fac);
    } else {
      const real u = (((lr * real(2)) * C(THIRD)) / sqrt2) / ls[m];
      a = (N[m] * real(0.5)) * (real(1) - erf_(u));
    }
    out[m * P.n] = raw(a);
  }
#undef C
}

// The two kernels, named so that a trace's kernel names show them beside
// PyTorch's elementwise kernels (`elementwise_kernel`).
__global__ void __launch_bounds__(kThreads)
    arg2000_number_elementwise_kernel(const __grid_constant__ Params P) {
  arg2000<false>(P);
}

__global__ void __launch_bounds__(kThreads)
    arg2000_mass_elementwise_kernel(const __grid_constant__ Params P) {
  arg2000<true>(P);
}

int launch(bool mass, const Params* p, int device, void* stream) {
  if (p->n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (p->n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (mass)
    arg2000_mass_elementwise_kernel<<<(unsigned)grid, kThreads, 0,
                                      (cudaStream_t)stream>>>(*p);
  else
    arg2000_number_elementwise_kernel<<<(unsigned)grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int arg2000_threads_per_block() { return kThreads; }
int arg2000_num_params() { return N_PARAMS; }
int arg2000_real_bytes() { return (int)sizeof(scalar); }
int arg2000_params_bytes() { return (int)sizeof(Params); }
int arg2000_modes() { return kModes; }

// The activated number (mass = 0) or mass (mass = 1) of each mode: one
// launch over the points of the parameter block `params` (a Params, which
// the kernel takes by value) on the stream.
int arg2000_launch(int mass, const void* params, int device, void* stream) {
  return launch(mass != 0, static_cast<const Params*>(params), device, stream);
}

// Registers and local memory bytes per thread of the number (mass = 0) or
// mass kernel, and its blocks resident on one SM.
int arg2000_kernel_attrs(int mass, int device, int* registers,
                         int* local_bytes, int* blocks) {
  cudaFuncAttributes a;
  const void* fn = mass ? (const void*)arg2000_mass_elementwise_kernel
                        : (const void*)arg2000_number_elementwise_kernel;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)err;
}

}  // extern "C"
