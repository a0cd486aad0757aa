// Per-cell device code of the SB2006 warm-rain step, shared by the 2M
// column kernel (column2m.cu) and the 2M + P3 column kernel (column_p3.cu).
//
// The includer first includes its generated parameter header, and chooses
// how a parameter is read:
// * by default from the parameter buffer `P` in global memory (float for
//   float cells, double for Dbl cells: param_t), at the index P_<name> of
//   the header (both parameter lists start with the 2M list, so the indices
//   agree), as the cells' type: the 2M + P3 kernel;
// * with WARM2M_LITERAL_PARAMS defined before the include, as the exact
//   float literal PC_<name> of the header, an immediate operand: the 2M
//   column kernel, built once per parameter block. The functions' `P`
//   argument is then not read (its caller passes nullptr), and there is no
//   second block of the list (PVO takes OFF == 0 only).
//
// The cell functions are templates on the scalar type R of the cells,
// deduced from their arguments: float for the float32 builds, real.cuh's
// Dbl for the float64 builds (a literal header writes double literals, a
// float64 parameter buffer holds doubles).
// Their math calls go through real.cuh, so R = float is the float code it
// always was.
//
// Each expression follows the eager PyTorch step's operation order as
// PyTorch's CUDA kernels evaluate it, so that the kernels round like their
// plain versions: `x / c` for a Python-float c is a multiply by c's
// reciprocal, taken in double on the host and rounded once to the cells'
// type (the INV_* parameters), `c / x` is reciprocal(x) * c, and pow with
// exponent 2 or 3 is products. Build without fast math, and with
// --fmad=false for float cells (real.cuh says how double cells are built).

#ifndef CMT_WARM2M_CUH
#define CMT_WARM2M_CUH

#include <cuda_runtime.h>

#include "real.cuh"

namespace warm2m {

using namespace rmath;

#ifdef WARM2M_LITERAL_PARAMS
// completed by PVO: a literal block has no second block to offset into
template <int OFF>
struct NoOffset {
  static_assert(OFF == 0, "literal parameters have no second block");
};
#define PV(name) (PC_##name)
#define PVO(name) ((void)sizeof(::warm2m::NoOffset<OFF>), (PC_##name))
#else
#define PV(name) ::warm2m::ldp(P + P_##name)
// the same name OFF entries further on: a second block of the parameter list
// laid out in the same order (the P3 kernel's ice rain PSD and ice Chen 2022
// rain coefficients)
#define PVO(name) ::warm2m::ldp(P + P_##name + OFF)
#endif

// the element type of the parameter buffer of cells computing on R, and a
// read-only load of one parameter as R
template <typename R>
struct ParamOf;
template <>
struct ParamOf<float> {
  using type = float;
};
template <>
struct ParamOf<Dbl> {
  using type = double;
};
template <typename R>
using param_t = typename ParamOf<R>::type;
__device__ __forceinline__ float ldp(const float* p) { return __ldg(p); }
__device__ __forceinline__ Dbl ldp(const double* p) { return Dbl(__ldg(p)); }

constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kSixth = (float)(1.0 / 6.0);

// 1/3 and 1/6 rounded once to R
template <typename R>
__device__ __forceinline__ constexpr R third() { return (R)(1.0 / 3.0); }
template <typename R>
__device__ __forceinline__ constexpr R sixth() { return (R)(1.0 / 6.0); }

// max/min that return `a` when it is NaN, as torch.clamp does
__device__ __forceinline__ float maxf(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float minf(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}
__device__ __forceinline__ Dbl maxf(Dbl a, Dbl b) { return a < b ? b : a; }
__device__ __forceinline__ Dbl minf(Dbl a, Dbl b) { return b < a ? b : a; }
__device__ __forceinline__ Dbl clampf(Dbl x, Dbl lo, Dbl hi) {
  return minf(maxf(x, lo), hi);
}

// `c / x` for a Python scalar c and a tensor x is reciprocal(x) * c in torch
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }
__device__ __forceinline__ Dbl rdiv(Dbl c, Dbl x) { return (Dbl(1) / x) * c; }

// torch.pow(x, p) for a scalar p on CUDA: sqrt, reciprocal and products for
// the special exponents, pow otherwise
template <typename R>
__device__ __forceinline__ R tpow_r(R x, R p) {
  if (p == R(1)) return x;
  if (p == R(2)) return x * x;
  if (p == R(3)) return x * x * x;
  if (p == R(0.5)) return sqrt_(x);
  if (p == R(-1)) return R(1) / x;
  if (p == R(-2)) return R(1) / (x * x);
  return pow_(x, p);
}
__device__ __forceinline__ float tpow(float x, float p) { return tpow_r(x, p); }
__device__ __forceinline__ Dbl tpow(Dbl x, Dbl p) { return tpow_r(x, p); }

template <typename R>
struct RainPDFT {
  R N0, Dr_mean, xr_mean;
};
using RainPDF = RainPDFT<float>;

// ops/m2.py:pdf_rain_parameters; OFF selects the block of the PSD's
// parameters (XR_MIN ... PI_RHO_W, in that order)
template <bool LIMITED, int OFF = 0, typename R>
__device__ __forceinline__ RainPDFT<R> pdf_rain(const param_t<R>* __restrict__ P,
                                                R q, R rho, R N) {
  const R em = PV(EM), en = PV(EN);
  const R safe_q = maxf(q, em);
  const R safe_N = maxf(N, en);
  const R L = rho * safe_q;
  R lam, xr, N0;
  bool cond;
  if (LIMITED) {
    const R x_t = clampf(L / safe_N, PVO(XR_MIN), PVO(XR_MAX));
    N0 = clampf(safe_N * tpow(rdiv(PVO(PI_RHO_W), x_t), third<R>()), PVO(N0_MIN),
                PVO(N0_MAX));
    lam = clampf(sqrt_(sqrt_(PVO(PI_RHO_W) * N0 / L)), PVO(LAM_MIN),
                 PVO(LAM_MAX));
    xr = clampf(L * lam / N0, PVO(XR_MIN), PVO(XR_MAX));
    cond = N < en && q < em;
  } else {
    xr = L / safe_N;
    lam = tpow(rdiv(PVO(PI_RHO_W), xr), third<R>());
    N0 = lam * safe_N;
    cond = N < en || q < em;
  }
  RainPDFT<R> r;
  r.N0 = cond ? R(0) : N0;
  r.Dr_mean = cond ? R(0) : R(1) / lam;
  r.xr_mean = cond ? R(0) : xr;
  return r;
}

// R itself, where an argument must not take part in deducing R (a literal
// parameter beside an R argument)
template <typename T>
struct Same {
  using type = T;
};
template <typename T>
using same_t = typename Same<T>::type;

// ops/m2.py:gamma_incl_approx with its four Python-float factors
template <typename R>
__device__ __forceinline__ R gamma_incl(R x, same_t<R> c0, same_t<R> e0,
                                        same_t<R> c1, same_t<R> e1) {
  return exp_(-x) / (c0 * tpow(x, e0) + c1 * tpow(x, e1));
}

// ops/m2.py:_sb_vel_helper's G4 moment factor
template <typename R>
__device__ __forceinline__ R sb_g4(R t) {
  return (t * t * t + R(3) * (t * t) + R(6) * t + R(6)) * exp_(-t);
}

// ops/common.py:chen2022_exponential_pdf, moment k (delta = k + 1)
template <typename R>
__device__ __forceinline__ R chen_term(R a, R b, R c, R lambda_inv, R delta,
                                       R inv_gamma_delta) {
  const R arg = -delta * log_(lambda_inv) -
                (b + delta) * log_(R(1) / lambda_inv + c) +
                lgamma_(b + delta);
  return a * exp_(arg) * inv_gamma_delta;
}

// ops/common.py:chen2022_vel_coeffs_rain: the air-density-dependent a_i
// (unit-converted), b_i and c_i (unit-converted) of the three Chen 2022 rain
// terms; OFF selects the block of the coefficients (CH_RHO0 ... CH_C3U, in
// that order)
template <typename R>
struct ChenRainT {
  R a[3], b[3], c[3];
};
using ChenRain = ChenRainT<float>;

template <int OFF = 0, typename R>
__device__ __forceinline__ ChenRainT<R> chen_rain_coeffs(const param_t<R>* __restrict__ P,
                                                         R rho) {
  const R rho_a = maxf(rho, R(0));
  const R shared = exp_(PVO(CH_RHO0) * rho_a - PVO(CH_BRHO) * rho_a * PVO(LOG1000));
  const R log_rho_a = log_(rho_a);
  ChenRainT<R> c;
  c.a[0] = PVO(CH_A1U) * shared;
  c.a[1] = PVO(CH_A2U) * shared;
  c.a[2] = PVO(CH_A3U) * shared * exp_(PVO(CH_A3POW) * log_rho_a);
  c.b[0] = PVO(CH_B1) - PVO(CH_BRHO) * rho_a;
  c.b[1] = PVO(CH_B2) - PVO(CH_BRHO) * rho_a;
  c.b[2] = PVO(CH_B3) - PVO(CH_BRHO) * rho_a;
  c.c[0] = PVO(CH_C1U);
  c.c[1] = PVO(CH_C2U);
  c.c[2] = PVO(CH_C3U);
  return c;
}

template <typename R>
struct WarmRatesT {
  R Lv;                              // latent heat of vaporization at T
  R dq_lcl, dn_lcl, dq_rai, dn_rai;  // models/tendencies.py:warm_rain_tendencies_2m
};
using WarmRates = WarmRatesT<float>;

// The rain PSD of the process rates (warm_rates: on the clamped state) and
// of the fall speeds (rain_fall_speeds: on the raw state), which the eager
// step evaluates twice. Their arguments agree bit for bit unless rho or
// n_rai is negative, and equal arguments give equal results: the second is
// then the first, not evaluated again.
template <bool LIMITED, typename R>
__device__ __forceinline__ void rain_pdfs(const param_t<R>* __restrict__ P, R rho,
                                          R q_rai, R n_rai,
                                          RainPDFT<R>& rates, RainPDFT<R>& speeds) {
  const R em = PV(EM), en = PV(EN);
  const R rho_c = maxf(rho, R(0));
  const R q_r = maxf(maxf(q_rai, R(0)), em);
  const R N_r = maxf(rho_c * maxf(n_rai, R(0)), en);
  const R q_s = maxf(q_rai, em);
  const R N_s = maxf(n_rai * rho, en);
  rates = pdf_rain<LIMITED>(P, q_r, rho_c, N_r);
  if (same_bits(q_r, q_s) && same_bits(rho_c, rho) && same_bits(N_r, N_s))
    speeds = rates;
  else
    speeds = pdf_rain<LIMITED>(P, q_s, rho, N_s);
}

// models/tendencies.py:bulk_tendencies_2m up to the warm-rain tendencies:
// the clamps, then warm_rain_tendencies_2m with the (clamped) ice content
// q_ice in the moist heat capacity and the vapor content (0 without ice);
// `pdf`: the rain PSD of the rates (rain_pdfs), evaluated here when null
template <bool LIMITED, typename R>
__device__ __forceinline__ WarmRatesT<R> warm_rates(const param_t<R>* __restrict__ P,
                                                    R rho, R T, R q_tot,
                                                    R q_lcl, R n_lcl,
                                                    R q_rai, R n_rai,
                                                    R q_ice,
                                                    const RainPDFT<R>* pdf = nullptr) {
  const R em = PV(EM), en = PV(EN);

  // ---- clamped state ---------------------------------------------------
  const R rho_c = maxf(rho, R(0));
  const R qt_c = maxf(q_tot, R(0));
  const R ql_c = maxf(q_lcl, R(0));
  const R qr_c = maxf(q_rai, R(0));
  const R nl_c = maxf(n_lcl, R(0));
  const R nr_c = maxf(n_rai, R(0));
  const R N_lcl = rho_c * nl_c;
  const R N_rai = rho_c * nr_c;

  // ---- thermodynamics (ops/thermo.py) ----------------------------------
  const R Lv = PV(LH_V0) + PV(DCP_VL) * (T - PV(T_0));
  const R q_liq = ql_c + qr_c;
  const R cp_air = PV(CP_D) + PV(CPVD) * qt_c + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
  const R qv = maxf(qt_c - q_liq - q_ice, R(0));
  const R inv_T = R(1) / T;
  const R p_sat = PV(PRESS_TRIPLE) *
                  exp_(PV(KV_L) * log_(T * PV(INV_T_TRIPLE)) +
                       PV(CL_L) * (PV(INV_T_TRIPLE) - inv_T));
  const R qv_sat = p_sat / (rho_c * PV(R_V) * T);

  // ---- condensation/evaporation, constant tau (ops/noneq.py) -----------
  R dq_cond;
  {
    const R dqdT = qv_sat * (Lv / (PV(R_V) * (T * T)) - inv_T);
    const R ts = PV(TAU_CE) * (R(1) + (Lv / cp_air) * dqdT);
    const R sat = qv - qv_sat;
    const R evap = -minf(-sat, maxf(ql_c, R(0))) / ts;
    const R dep = sat / ts;
    dq_cond = sat < R(0) ? evap : dep;
  }

  // ---- rain PSD of the rates: evaporation, self-collection, breakup ----
  const R xr_mean =
      (pdf ? *pdf : pdf_rain<LIMITED>(P, maxf(qr_c, em), rho_c, maxf(N_rai, en))).xr_mean;
  const R xr_safe = maxf(xr_mean, PV(TINY));
  const R Dr = tpow(R(6) * xr_safe * PV(INV_PI_RHO_W), third<R>());

  // ---- rain evaporation (ops/m2.py:rain_evaporation) -------------------
  R dn_evap, dq_evap;
  {
    const R p_v = qv * rho_c * PV(R_V) * T;
    const R S = p_v / p_sat - R(1);
    const R p_vs = maxf(p_sat, PV(EPS_PSAT));
    const R G = R(1) / (Lv * PV(INV_K_THERM) / T * (Lv * PV(INV_R_V) / T - R(1)) +
                        PV(R_V) * T * PV(INV_D_VAPOR) / p_vs);
    const R t_star = tpow(rdiv(PV(SIX_X_STAR), xr_safe), third<R>());
    const R a_vent_0 = PV(A_VENT_0) * gamma_incl(t_star, PV(GIA_C0_A), PV(GIA_E0_A),
                                                 PV(GIA_C1_A), PV(GIA_E1_A));
    const R b_vent_0 = PV(B_VENT_0) * gamma_incl(t_star, PV(GIA_C0_B), PV(GIA_E0_B),
                                                 PV(GIA_C1_B), PV(GIA_E1_B));
    const R N_Re = PV(ALPHA) * tpow(xr_safe, PV(BETA)) *
                   sqrt_(rdiv(PV(EVAP_RHO0), rho_c)) * Dr * PV(INV_NU_AIR);
    const R sqrt_N_Re = sqrt_(N_Re);
    const R Fv0 = a_vent_0 + b_vent_0 * PV(CBRT_SC) * sqrt_N_Re;
    const R Fv1 = PV(A_VENT_1) + PV(B_VENT_1_SC) * sqrt_N_Re;
    const R common = PV(TWO_PI) * G * S * N_rai * Dr;
    const R dn = minf(common * Fv0 / xr_safe, R(0));
    const R dq = minf(common * Fv1 / rho_c, R(0));
    const bool no_rain = qr_c < em || N_rai <= en || S >= R(0);
    dn_evap = (no_rain || xr_mean * PV(INV_XR_MIN) < PV(EPS_MACH)) ? R(0) : dn;
    dq_evap = no_rain ? R(0) : dq;
  }

  // ---- autoconversion + cloud self-collection --------------------------
  R au_dq_lcl, au_dN_lcl, au_dq_rai, au_dN_rai, sc_lcl;
  {
    const R sql = maxf(ql_c, em);
    const R sNl = maxf(N_lcl, en);
    const R L_lcl = rho_c * sql;
    const R x_lcl = minf(L_lcl / sNl, PV(X_STAR));
    const R sqr = maxf(qr_c, R(0));
    const R tau = R(1) - sql / (sql + sqr);
    const R tau_safe = maxf(tau, em);
    const R ta = tpow(tau_safe, PV(ACNV_AEXP));
    const R phi_au =
        qr_c < em ? R(0) : PV(ACNV_A) * ta * tpow(R(1) - ta, PV(ACNV_BEXP));
    const R omt = R(1) - tau;
    const R dL = PV(ACNV_C) * (L_lcl * L_lcl) * (x_lcl * x_lcl) *
                 (R(1) + phi_au / (omt * omt)) * PV(ACNV_RHO0) / rho_c;
    const R dN_rai = dL * PV(INV_X_STAR);
    const bool cond = ql_c < em || N_lcl < en;
    au_dq_lcl = cond ? R(0) : -dL / rho_c;
    au_dN_lcl = cond ? R(0) : R(-2) * dN_rai;
    au_dq_rai = cond ? R(0) : dL / rho_c;
    au_dN_rai = cond ? R(0) : dN_rai;

    const R L2 = rho_c * ql_c;
    const R rate = PV(SC_LCL_C) * rdiv(PV(ACNV_RHO0), rho_c) * (L2 * L2) - au_dN_lcl;
    sc_lcl = ql_c < em ? R(0) : rate;
  }

  // ---- accretion -------------------------------------------------------
  R ac_dq_lcl, ac_dN_lcl, ac_dq_rai;
  {
    const R sql = maxf(ql_c, em);
    const R sqr = maxf(qr_c, em);
    const R sNl = maxf(N_lcl, en);
    const R L_lcl = rho_c * sql;
    const R L_rai = rho_c * sqr;
    const R x_lcl = L_lcl / sNl;
    const R tau = R(1) - sql / (sql + sqr);
    const R phi_ac = tpow(tau / (tau + PV(TAU0)), PV(ACCR_C));
    const R dL_rai =
        PV(KCR) * L_lcl * L_rai * phi_ac * sqrt_(rdiv(PV(ACCR_RHO0), rho_c));
    const R dL_lcl = -dL_rai;
    const bool cond = ql_c < em || qr_c < em || N_lcl < en;
    ac_dq_lcl = cond ? R(0) : dL_lcl / rho_c;
    ac_dN_lcl = cond ? R(0) : dL_lcl / x_lcl;
    ac_dq_rai = cond ? R(0) : dL_rai / rho_c;
  }

  // ---- rain self-collection + breakup ----------------------------------
  R sc_rai, br_rai;
  {
    const R L_rai = rho_c * maxf(qr_c, em);
    const R Br = tpow(rdiv(R(6), xr_mean), third<R>());
    const R rate = PV(KRR_NEG) * N_rai * L_rai * sqrt_(rdiv(PV(PDF_RHO0), rho_c)) *
                   tpow(R(1) + rdiv(PV(KAPPA_RR), Br), PV(SC_D));
    const bool cond = qr_c < em || N_rai < en;
    sc_rai = cond ? R(0) : rate;

    const R dD = Dr - PV(DEQ);
    const R phi_br = Dr < PV(DR_TH)
                         ? R(-1)
                         : (Dr <= PV(DEQ) ? PV(KBR) * dD : exp_(PV(KAPPA_BR) * dD) - R(1));
    br_rai = cond ? R(0) : -(phi_br + R(1)) * sc_rai;
  }

  // ---- number adjustment from mass limits (Horn 2012) ------------------
  const R n_tgt_lcl =
      ql_c < em ? R(0)
                : clampf(nl_c, ql_c * PV(INV_XC_MAX), ql_c * PV(INV_XC_MIN));
  const R numadj_lcl = (n_tgt_lcl - nl_c) * PV(INV_NUMADJ_TAU);
  const R n_tgt_rai =
      qr_c < em ? R(0)
                : clampf(nr_c, qr_c * PV(INV_XR_MAX), qr_c * PV(INV_XR_MIN));
  const R numadj_rai = (n_tgt_rai - nr_c) * PV(INV_NUMADJ_TAU);

  WarmRatesT<R> o;
  o.Lv = Lv;
  o.dq_lcl = dq_cond + au_dq_lcl + ac_dq_lcl;
  o.dq_rai = dq_evap + au_dq_rai + ac_dq_rai;
  o.dn_lcl = (au_dN_lcl + sc_lcl + ac_dN_lcl) / rho_c + numadj_lcl;
  o.dn_rai = (dn_evap + au_dN_rai + sc_rai + br_rai) / rho_c + numadj_rai;
  return o;
}

template <typename R>
struct RainSpeedsT {
  R vt_n, vt_m;  // number- and mass-weighted rain fall speeds [m/s]
};
using RainSpeeds = RainSpeedsT<float>;

// ops/m2.py:rain_terminal_velocity on the unclamped state, as the column
// step calls it: SB2006 (Rogers-type) or Chen 2022 fall speeds; `pdf`: the
// rain PSD of the fall speeds (rain_pdfs), evaluated here when null
template <bool LIMITED, bool CHEN, typename R>
__device__ __forceinline__ RainSpeedsT<R> rain_fall_speeds(const param_t<R>* __restrict__ P,
                                                           R rho, R q_rai,
                                                           R n_rai,
                                                           const RainPDFT<R>* pdf = nullptr) {
  const R em = PV(EM), en = PV(EN);
  const R N_v = n_rai * rho;
  const R Dm =
      (pdf ? *pdf : pdf_rain<LIMITED>(P, maxf(q_rai, em), rho, maxf(N_v, en))).Dr_mean;
  R v0, v1;
  if (CHEN) {
    const ChenRainT<R> c = chen_rain_coeffs(P, rho);
    v0 = chen_term(c.a[0], c.b[0], c.c[0], Dm, R(1), R(1)) +
         chen_term(c.a[1], c.b[1], c.c[1], Dm, R(1), R(1)) +
         chen_term(c.a[2], c.b[2], c.c[2], Dm, R(1), R(1));
    v1 = chen_term(c.a[0], c.b[0], c.c[0], Dm, R(4), sixth<R>()) +
         chen_term(c.a[1], c.b[1], c.c[1], Dm, R(4), sixth<R>()) +
         chen_term(c.a[2], c.b[2], c.c[2], Dm, R(4), sixth<R>());
  } else {
    R pa0 = R(1), pb0 = R(1), pa1 = R(1), pb1 = R(1);
    if (!LIMITED) {
      const R lam_r = R(1) / Dm;
      const R ta = PV(TWO_RC) * lam_r;
      const R tb = PV(TWO_RC) * (lam_r + PV(CR));
      pa0 = exp_(-ta);
      pb0 = exp_(-tb);
      pa1 = sb_g4(ta) * sixth<R>();
      pb1 = sb_g4(tb) * sixth<R>();
    }
    const R sq = sqrt_(rdiv(PV(VEL_RHO0), rho));
    const R den = R(1) + PV(CR) * Dm;
    v0 = sq * (PV(AR) * pa0 - PV(BR) * pb0 / den);
    v1 = sq * (PV(AR) * pa1 - PV(BR) * pb1 / pow_(den, R(4)));
  }
  RainSpeedsT<R> s;
  s.vt_n = N_v < en ? R(0) : maxf(v0, R(0));
  s.vt_m = q_rai < em ? R(0) : maxf(v1, R(0));
  return s;
}

}  // namespace warm2m

#endif  // CMT_WARM2M_CUH
