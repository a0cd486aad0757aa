// Per-cell device code of the SB2006 warm-rain step, shared by the 2M
// column kernel (column2m.cu) and the 2M + P3 column kernel (column_p3.cu).
//
// The includer first includes its generated parameter header, and chooses
// how a parameter is read:
// * by default from the float32 parameter buffer `P` in global memory, at
//   the index P_<name> of the header (both parameter lists start with the
//   2M list, so the indices agree): the 2M + P3 kernel;
// * with WARM2M_LITERAL_PARAMS defined before the include, as the exact
//   float literal PC_<name> of the header, an immediate operand: the 2M
//   column kernel, built once per parameter block. The functions' `P`
//   argument is then not read (its caller passes nullptr), and there is no
//   second block of the list (PVO takes OFF == 0 only).
//
// Each expression follows the eager PyTorch step's operation order as
// PyTorch's CUDA kernels evaluate it, so that the kernels round like their
// plain versions: `x / c` for a Python-float c is a multiply by c's
// reciprocal, taken in double on the host and rounded once to float (the
// INV_* parameters), `c / x` is reciprocal(x) * c, and pow with exponent 2
// or 3 is products. Build with --fmad=false and without fast math.

#ifndef CMT_WARM2M_CUH
#define CMT_WARM2M_CUH

#include <cuda_runtime.h>

namespace warm2m {

#ifdef WARM2M_LITERAL_PARAMS
// completed by PVO: a literal block has no second block to offset into
template <int OFF>
struct NoOffset {
  static_assert(OFF == 0, "literal parameters have no second block");
};
#define PV(name) (PC_##name)
#define PVO(name) ((void)sizeof(::warm2m::NoOffset<OFF>), (PC_##name))
#else
#define PV(name) __ldg(P + P_##name)
// the same name OFF entries further on: a second block of the parameter list
// laid out in the same order (the P3 kernel's ice rain PSD and ice Chen 2022
// rain coefficients)
#define PVO(name) __ldg(P + P_##name + OFF)
#endif

constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kSixth = (float)(1.0 / 6.0);

// max/min that return `a` when it is NaN, as torch.clamp does
__device__ __forceinline__ float maxf(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float minf(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}

// `c / x` for a Python scalar c and a tensor x is reciprocal(x) * c in torch
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

// torch.pow(x, p) for a scalar p on CUDA: sqrt, reciprocal and products for
// the special exponents, powf otherwise
__device__ __forceinline__ float tpow(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 0.5f) return sqrtf(x);
  if (p == -1.0f) return 1.0f / x;
  if (p == -2.0f) return 1.0f / (x * x);
  return powf(x, p);
}

struct RainPDF {
  float N0, Dr_mean, xr_mean;
};

// ops/m2.py:pdf_rain_parameters; OFF selects the block of the PSD's
// parameters (XR_MIN ... PI_RHO_W, in that order)
template <bool LIMITED, int OFF = 0>
__device__ __forceinline__ RainPDF pdf_rain(const float* __restrict__ P,
                                            float q, float rho, float N) {
  const float em = PV(EM), en = PV(EN);
  const float safe_q = maxf(q, em);
  const float safe_N = maxf(N, en);
  const float L = rho * safe_q;
  float lam, xr, N0;
  bool cond;
  if (LIMITED) {
    const float x_t = clampf(L / safe_N, PVO(XR_MIN), PVO(XR_MAX));
    N0 = clampf(safe_N * tpow(rdiv(PVO(PI_RHO_W), x_t), kThird), PVO(N0_MIN),
                PVO(N0_MAX));
    lam = clampf(sqrtf(sqrtf(PVO(PI_RHO_W) * N0 / L)), PVO(LAM_MIN),
                 PVO(LAM_MAX));
    xr = clampf(L * lam / N0, PVO(XR_MIN), PVO(XR_MAX));
    cond = N < en && q < em;
  } else {
    xr = L / safe_N;
    lam = tpow(rdiv(PVO(PI_RHO_W), xr), kThird);
    N0 = lam * safe_N;
    cond = N < en || q < em;
  }
  RainPDF r;
  r.N0 = cond ? 0.0f : N0;
  r.Dr_mean = cond ? 0.0f : 1.0f / lam;
  r.xr_mean = cond ? 0.0f : xr;
  return r;
}

// ops/m2.py:gamma_incl_approx with its four Python-float factors
__device__ __forceinline__ float gamma_incl(float x, float c0, float e0,
                                            float c1, float e1) {
  return expf(-x) / (c0 * tpow(x, e0) + c1 * tpow(x, e1));
}

// ops/m2.py:_sb_vel_helper's G4 moment factor
__device__ __forceinline__ float sb_g4(float t) {
  return (t * t * t + 3.0f * (t * t) + 6.0f * t + 6.0f) * expf(-t);
}

// ops/common.py:chen2022_exponential_pdf, moment k (delta = k + 1)
__device__ __forceinline__ float chen_term(float a, float b, float c,
                                           float lambda_inv, float delta,
                                           float inv_gamma_delta) {
  const float arg = -delta * logf(lambda_inv) -
                    (b + delta) * logf(1.0f / lambda_inv + c) +
                    lgammaf(b + delta);
  return a * expf(arg) * inv_gamma_delta;
}

// ops/common.py:chen2022_vel_coeffs_rain: the air-density-dependent a_i
// (unit-converted), b_i and c_i (unit-converted) of the three Chen 2022 rain
// terms; OFF selects the block of the coefficients (CH_RHO0 ... CH_C3U, in
// that order)
struct ChenRain {
  float a[3], b[3], c[3];
};

template <int OFF = 0>
__device__ __forceinline__ ChenRain chen_rain_coeffs(const float* __restrict__ P,
                                                     float rho) {
  const float rho_a = maxf(rho, 0.0f);
  const float shared = expf(PVO(CH_RHO0) * rho_a - PVO(CH_BRHO) * rho_a * PVO(LOG1000));
  const float log_rho_a = logf(rho_a);
  ChenRain c;
  c.a[0] = PVO(CH_A1U) * shared;
  c.a[1] = PVO(CH_A2U) * shared;
  c.a[2] = PVO(CH_A3U) * shared * expf(PVO(CH_A3POW) * log_rho_a);
  c.b[0] = PVO(CH_B1) - PVO(CH_BRHO) * rho_a;
  c.b[1] = PVO(CH_B2) - PVO(CH_BRHO) * rho_a;
  c.b[2] = PVO(CH_B3) - PVO(CH_BRHO) * rho_a;
  c.c[0] = PVO(CH_C1U);
  c.c[1] = PVO(CH_C2U);
  c.c[2] = PVO(CH_C3U);
  return c;
}

struct WarmRates {
  float Lv;                              // latent heat of vaporization at T
  float dq_lcl, dn_lcl, dq_rai, dn_rai;  // models/tendencies.py:warm_rain_tendencies_2m
};

// The rain PSD of the process rates (warm_rates: on the clamped state) and
// of the fall speeds (rain_fall_speeds: on the raw state), which the eager
// step evaluates twice. Their arguments agree bit for bit unless rho or
// n_rai is negative, and equal arguments give equal results: the second is
// then the first, not evaluated again.
template <bool LIMITED>
__device__ __forceinline__ void rain_pdfs(const float* __restrict__ P, float rho,
                                          float q_rai, float n_rai,
                                          RainPDF& rates, RainPDF& speeds) {
  const float em = PV(EM), en = PV(EN);
  const float rho_c = maxf(rho, 0.0f);
  const float q_r = maxf(maxf(q_rai, 0.0f), em);
  const float N_r = maxf(rho_c * maxf(n_rai, 0.0f), en);
  const float q_s = maxf(q_rai, em);
  const float N_s = maxf(n_rai * rho, en);
  rates = pdf_rain<LIMITED>(P, q_r, rho_c, N_r);
  if (__float_as_uint(q_r) == __float_as_uint(q_s) &&
      __float_as_uint(rho_c) == __float_as_uint(rho) &&
      __float_as_uint(N_r) == __float_as_uint(N_s))
    speeds = rates;
  else
    speeds = pdf_rain<LIMITED>(P, q_s, rho, N_s);
}

// models/tendencies.py:bulk_tendencies_2m up to the warm-rain tendencies:
// the clamps, then warm_rain_tendencies_2m with the (clamped) ice content
// q_ice in the moist heat capacity and the vapor content (0 without ice);
// `pdf`: the rain PSD of the rates (rain_pdfs), evaluated here when null
template <bool LIMITED>
__device__ __forceinline__ WarmRates warm_rates(const float* __restrict__ P,
                                                float rho, float T, float q_tot,
                                                float q_lcl, float n_lcl,
                                                float q_rai, float n_rai,
                                                float q_ice,
                                                const RainPDF* pdf = nullptr) {
  const float em = PV(EM), en = PV(EN);

  // ---- clamped state ---------------------------------------------------
  const float rho_c = maxf(rho, 0.0f);
  const float qt_c = maxf(q_tot, 0.0f);
  const float ql_c = maxf(q_lcl, 0.0f);
  const float qr_c = maxf(q_rai, 0.0f);
  const float nl_c = maxf(n_lcl, 0.0f);
  const float nr_c = maxf(n_rai, 0.0f);
  const float N_lcl = rho_c * nl_c;
  const float N_rai = rho_c * nr_c;

  // ---- thermodynamics (ops/thermo.py) ----------------------------------
  const float Lv = PV(LH_V0) + PV(DCP_VL) * (T - PV(T_0));
  const float q_liq = ql_c + qr_c;
  const float cp_air = PV(CP_D) + PV(CPVD) * qt_c + PV(CPLV) * q_liq + PV(CPIV) * q_ice;
  const float qv = maxf(qt_c - q_liq - q_ice, 0.0f);
  const float inv_T = 1.0f / T;
  const float p_sat = PV(PRESS_TRIPLE) *
                      expf(PV(KV_L) * logf(T * PV(INV_T_TRIPLE)) +
                           PV(CL_L) * (PV(INV_T_TRIPLE) - inv_T));
  const float qv_sat = p_sat / (rho_c * PV(R_V) * T);

  // ---- condensation/evaporation, constant tau (ops/noneq.py) -----------
  float dq_cond;
  {
    const float dqdT = qv_sat * (Lv / (PV(R_V) * (T * T)) - inv_T);
    const float ts = PV(TAU_CE) * (1.0f + (Lv / cp_air) * dqdT);
    const float sat = qv - qv_sat;
    const float evap = -minf(-sat, maxf(ql_c, 0.0f)) / ts;
    const float dep = sat / ts;
    dq_cond = sat < 0.0f ? evap : dep;
  }

  // ---- rain PSD of the rates: evaporation, self-collection, breakup ----
  const float xr_mean =
      (pdf ? *pdf : pdf_rain<LIMITED>(P, maxf(qr_c, em), rho_c, maxf(N_rai, en))).xr_mean;
  const float xr_safe = maxf(xr_mean, PV(TINY));
  const float Dr = tpow(6.0f * xr_safe * PV(INV_PI_RHO_W), kThird);

  // ---- rain evaporation (ops/m2.py:rain_evaporation) -------------------
  float dn_evap, dq_evap;
  {
    const float p_v = qv * rho_c * PV(R_V) * T;
    const float S = p_v / p_sat - 1.0f;
    const float p_vs = maxf(p_sat, PV(EPS_PSAT));
    const float G = 1.0f / (Lv * PV(INV_K_THERM) / T * (Lv * PV(INV_R_V) / T - 1.0f) +
                            PV(R_V) * T * PV(INV_D_VAPOR) / p_vs);
    const float t_star = tpow(rdiv(PV(SIX_X_STAR), xr_safe), kThird);
    const float a_vent_0 = PV(A_VENT_0) * gamma_incl(t_star, PV(GIA_C0_A), PV(GIA_E0_A),
                                                     PV(GIA_C1_A), PV(GIA_E1_A));
    const float b_vent_0 = PV(B_VENT_0) * gamma_incl(t_star, PV(GIA_C0_B), PV(GIA_E0_B),
                                                     PV(GIA_C1_B), PV(GIA_E1_B));
    const float N_Re = PV(ALPHA) * tpow(xr_safe, PV(BETA)) *
                       sqrtf(rdiv(PV(EVAP_RHO0), rho_c)) * Dr * PV(INV_NU_AIR);
    const float sqrt_N_Re = sqrtf(N_Re);
    const float Fv0 = a_vent_0 + b_vent_0 * PV(CBRT_SC) * sqrt_N_Re;
    const float Fv1 = PV(A_VENT_1) + PV(B_VENT_1_SC) * sqrt_N_Re;
    const float common = PV(TWO_PI) * G * S * N_rai * Dr;
    const float dn = minf(common * Fv0 / xr_safe, 0.0f);
    const float dq = minf(common * Fv1 / rho_c, 0.0f);
    const bool no_rain = qr_c < em || N_rai <= en || S >= 0.0f;
    dn_evap = (no_rain || xr_mean * PV(INV_XR_MIN) < PV(EPS_MACH)) ? 0.0f : dn;
    dq_evap = no_rain ? 0.0f : dq;
  }

  // ---- autoconversion + cloud self-collection --------------------------
  float au_dq_lcl, au_dN_lcl, au_dq_rai, au_dN_rai, sc_lcl;
  {
    const float sql = maxf(ql_c, em);
    const float sNl = maxf(N_lcl, en);
    const float L_lcl = rho_c * sql;
    const float x_lcl = minf(L_lcl / sNl, PV(X_STAR));
    const float sqr = maxf(qr_c, 0.0f);
    const float tau = 1.0f - sql / (sql + sqr);
    const float tau_safe = maxf(tau, em);
    const float ta = tpow(tau_safe, PV(ACNV_AEXP));
    const float phi_au =
        qr_c < em ? 0.0f : PV(ACNV_A) * ta * tpow(1.0f - ta, PV(ACNV_BEXP));
    const float omt = 1.0f - tau;
    const float dL = PV(ACNV_C) * (L_lcl * L_lcl) * (x_lcl * x_lcl) *
                     (1.0f + phi_au / (omt * omt)) * PV(ACNV_RHO0) / rho_c;
    const float dN_rai = dL * PV(INV_X_STAR);
    const bool cond = ql_c < em || N_lcl < en;
    au_dq_lcl = cond ? 0.0f : -dL / rho_c;
    au_dN_lcl = cond ? 0.0f : -2.0f * dN_rai;
    au_dq_rai = cond ? 0.0f : dL / rho_c;
    au_dN_rai = cond ? 0.0f : dN_rai;

    const float L2 = rho_c * ql_c;
    const float rate = PV(SC_LCL_C) * rdiv(PV(ACNV_RHO0), rho_c) * (L2 * L2) - au_dN_lcl;
    sc_lcl = ql_c < em ? 0.0f : rate;
  }

  // ---- accretion -------------------------------------------------------
  float ac_dq_lcl, ac_dN_lcl, ac_dq_rai;
  {
    const float sql = maxf(ql_c, em);
    const float sqr = maxf(qr_c, em);
    const float sNl = maxf(N_lcl, en);
    const float L_lcl = rho_c * sql;
    const float L_rai = rho_c * sqr;
    const float x_lcl = L_lcl / sNl;
    const float tau = 1.0f - sql / (sql + sqr);
    const float phi_ac = tpow(tau / (tau + PV(TAU0)), PV(ACCR_C));
    const float dL_rai =
        PV(KCR) * L_lcl * L_rai * phi_ac * sqrtf(rdiv(PV(ACCR_RHO0), rho_c));
    const float dL_lcl = -dL_rai;
    const bool cond = ql_c < em || qr_c < em || N_lcl < en;
    ac_dq_lcl = cond ? 0.0f : dL_lcl / rho_c;
    ac_dN_lcl = cond ? 0.0f : dL_lcl / x_lcl;
    ac_dq_rai = cond ? 0.0f : dL_rai / rho_c;
  }

  // ---- rain self-collection + breakup ----------------------------------
  float sc_rai, br_rai;
  {
    const float L_rai = rho_c * maxf(qr_c, em);
    const float Br = tpow(rdiv(6.0f, xr_mean), kThird);
    const float rate = PV(KRR_NEG) * N_rai * L_rai * sqrtf(rdiv(PV(PDF_RHO0), rho_c)) *
                       tpow(1.0f + rdiv(PV(KAPPA_RR), Br), PV(SC_D));
    const bool cond = qr_c < em || N_rai < en;
    sc_rai = cond ? 0.0f : rate;

    const float dD = Dr - PV(DEQ);
    const float phi_br = Dr < PV(DR_TH)
                             ? -1.0f
                             : (Dr <= PV(DEQ) ? PV(KBR) * dD : expf(PV(KAPPA_BR) * dD) - 1.0f);
    br_rai = cond ? 0.0f : -(phi_br + 1.0f) * sc_rai;
  }

  // ---- number adjustment from mass limits (Horn 2012) ------------------
  const float n_tgt_lcl =
      ql_c < em ? 0.0f
                : clampf(nl_c, ql_c * PV(INV_XC_MAX), ql_c * PV(INV_XC_MIN));
  const float numadj_lcl = (n_tgt_lcl - nl_c) * PV(INV_NUMADJ_TAU);
  const float n_tgt_rai =
      qr_c < em ? 0.0f
                : clampf(nr_c, qr_c * PV(INV_XR_MAX), qr_c * PV(INV_XR_MIN));
  const float numadj_rai = (n_tgt_rai - nr_c) * PV(INV_NUMADJ_TAU);

  WarmRates o;
  o.Lv = Lv;
  o.dq_lcl = dq_cond + au_dq_lcl + ac_dq_lcl;
  o.dq_rai = dq_evap + au_dq_rai + ac_dq_rai;
  o.dn_lcl = (au_dN_lcl + sc_lcl + ac_dN_lcl) / rho_c + numadj_lcl;
  o.dn_rai = (dn_evap + au_dN_rai + sc_rai + br_rai) / rho_c + numadj_rai;
  return o;
}

struct RainSpeeds {
  float vt_n, vt_m;  // number- and mass-weighted rain fall speeds [m/s]
};

// ops/m2.py:rain_terminal_velocity on the unclamped state, as the column
// step calls it: SB2006 (Rogers-type) or Chen 2022 fall speeds; `pdf`: the
// rain PSD of the fall speeds (rain_pdfs), evaluated here when null
template <bool LIMITED, bool CHEN>
__device__ __forceinline__ RainSpeeds rain_fall_speeds(const float* __restrict__ P,
                                                       float rho, float q_rai,
                                                       float n_rai,
                                                       const RainPDF* pdf = nullptr) {
  const float em = PV(EM), en = PV(EN);
  const float N_v = n_rai * rho;
  const float Dm =
      (pdf ? *pdf : pdf_rain<LIMITED>(P, maxf(q_rai, em), rho, maxf(N_v, en))).Dr_mean;
  float v0, v1;
  if (CHEN) {
    const ChenRain c = chen_rain_coeffs(P, rho);
    v0 = chen_term(c.a[0], c.b[0], c.c[0], Dm, 1.0f, 1.0f) +
         chen_term(c.a[1], c.b[1], c.c[1], Dm, 1.0f, 1.0f) +
         chen_term(c.a[2], c.b[2], c.c[2], Dm, 1.0f, 1.0f);
    v1 = chen_term(c.a[0], c.b[0], c.c[0], Dm, 4.0f, kSixth) +
         chen_term(c.a[1], c.b[1], c.c[1], Dm, 4.0f, kSixth) +
         chen_term(c.a[2], c.b[2], c.c[2], Dm, 4.0f, kSixth);
  } else {
    float pa0 = 1.0f, pb0 = 1.0f, pa1 = 1.0f, pb1 = 1.0f;
    if (!LIMITED) {
      const float lam_r = 1.0f / Dm;
      const float ta = PV(TWO_RC) * lam_r;
      const float tb = PV(TWO_RC) * (lam_r + PV(CR));
      pa0 = expf(-ta);
      pb0 = expf(-tb);
      pa1 = sb_g4(ta) * kSixth;
      pb1 = sb_g4(tb) * kSixth;
    }
    const float sq = sqrtf(rdiv(PV(VEL_RHO0), rho));
    const float den = 1.0f + PV(CR) * Dm;
    v0 = sq * (PV(AR) * pa0 - PV(BR) * pb0 / den);
    v1 = sq * (PV(AR) * pa1 - PV(BR) * pb1 / powf(den, 4.0f));
  }
  RainSpeeds s;
  s.vt_n = N_v < en ? 0.0f : maxf(v0, 0.0f);
  s.vt_m = q_rai < em ? 0.0f : maxf(v1, 0.0f);
  return s;
}

}  // namespace warm2m

#endif  // CMT_WARM2M_CUH
