"""P3 scheme core: state, thresholds, size distribution, shape solver,
integral properties, and terminal velocities.

Port of ``cloudmicrophysics_tpu/ops/p3.py`` (reference P3 files):

* ``src/P3_particle_properties.jl`` — ``P3State`` with thresholds cached at
  construction; numerically stable ``get_rho_d`` via exprel phi-functions;
  branchless 5-regime selection; mass/area/density/aspect-ratio laws.
* ``src/P3_size_distribution.jl`` — log-space incomplete-gamma moments,
  mu(lambda) laws, segment-summed mass moments via logsumexp, and the
  **shape solver**: fixed-iteration branchless Brent over ``logLdivN``
  with optional warm-start bracket narrowing.
* ``src/P3_integral_properties.jl`` — quantile integral bounds, ``D_m``.
* ``src/P3_terminal_velocity.jl`` — piecewise Chen 2022 ice velocity with
  aspect-ratio factor; number-/mass-weighted bulk velocities by quadrature.

Everything is elementwise over cell state; quadrature sums over a leading
node axis, one node at a time in node order. The shape solver runs a fixed trip count (8 at float32, 10 at
float64) with no early exit. Off the column step's path:
``get_distribution_loglambda_from_prognostic``, the experimental
``get_distribution_loglambda_all_solutions`` and the linear-space
``gamma_inc_moment``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parameters.p3 import OBLATE, ParametersP3, SlopeConstant, SlopePowerLaw
from ..parameters.terminal_velocity import Chen2022VelType
from ..utils.quadrature import QuadratureRule, default_quadrature, sum_nodes
from ..utils.special import (
    cbrt,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    eps_numerics_P3_B,
    expm1,
    float_dtype,
    floatmin,
    gamma,
    gamma_inc,
    lgamma,
    logsumexp,
    machine_eps,
    rime_density,
    rime_mass_fraction,
)
from . import common as CO

PI = math.pi

__all__ = [
    "P3State",
    "p3_state",
    "state_from_prognostic",
    "get_rho_d",
    "get_rho_g",
    "segment_boundaries",
    "regime_value",
    "ice_mass",
    "ice_mass_coeffs",
    "ice_area",
    "ice_density",
    "d_ice_mass_dD",
    "phi_i",
    "aspect_ratio_factor",
    "get_mu",
    "log_nprime_ice",
    "size_distribution",
    "loggamma_inc_moment",
    "loggamma_moment",
    "logmass_gamma_moment",
    "logLdivN",
    "get_logN0",
    "gamma_inc_moment",
    "get_distribution_loglambda",
    "get_distribution_loglambda_all_solutions",
    "get_distribution_loglambda_from_prognostic",
    "integral_bounds",
    "D_m",
    "IceQuadNodes",
    "ice_quadrature_nodes",
    "ice_particle_terminal_velocity",
    "ice_terminal_velocity_number_weighted",
    "ice_terminal_velocity_mass_weighted",
]


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, value)


# ---------------------------------------------------------------------------
# exprel phi-functions (reference src/P3_particle_properties.jl:118-153)
# ---------------------------------------------------------------------------

def _exprel1(x):
    """``(exp(x) - 1) / x``, stable at 0."""
    small = torch.abs(x) < 1e-8
    x_safe = torch.where(small, torch.ones_like(x), x)
    out = expm1(x_safe) / x_safe
    return torch.where(small, 1 + x / 2, out)


_EXPREL2_COEFFS = tuple(1.0 / math.factorial(i + 1) for i in range(1, 9))


def _exprel2(x):
    """``(exp(x) - 1 - x) / x^2`` with Taylor fallback for small |x|."""
    small = torch.abs(x) < 0.2
    x_safe = torch.where(small, torch.ones_like(x), x)
    direct = (expm1(x_safe) - x_safe) / (x_safe * x_safe)
    taylor = torch.zeros_like(x)
    for c in _EXPREL2_COEFFS[::-1]:
        taylor = taylor * x + c
    return torch.where(small, taylor, direct)


def get_rho_d(mass, F_rim, rho_rim):
    """Density of the unrimed portion, exact stable form
    (reference src/P3_particle_properties.jl:191-199)."""
    p = 1 / (3 - mass.beta_va)
    # clamp so log1p stays finite for F_rim -> 1
    F = torch.clamp(F_rim, max=1 - machine_eps(F_rim.dtype))
    logFu = torch.log1p(-F)
    phi1 = _exprel1(logFu)
    phi1mp = _exprel1((1 - p) * logFu)
    H = (-p * _exprel2(-p * logFu) - (1 - p) * _exprel2((1 - p) * logFu))
    G = H - phi1mp * phi1
    return -(rho_rim * phi1 * phi1mp) / G


def weighted_average(f_a, a, b):
    return f_a * a + (1 - f_a) * b


def get_rho_g(F_rim, rho_rim, rho_d):
    """Graupel density (MM2015 Eq 16)."""
    return weighted_average(F_rim, rho_rim, rho_d)


def _threshold(mass, rho):
    """``(6 alpha_va / (pi rho))^(1/(3 - beta_va))``
    (reference src/P3_particle_properties.jl:244)."""
    return (6 * mass.alpha_va / (PI * rho)) ** (1 / (3 - mass.beta_va))


class P3State(NamedTuple):
    """P3 state with thresholds cached at construction
    (reference src/P3_particle_properties.jl:20-56)."""

    params: ParametersP3
    rho_q_ice: torch.Tensor   # volumetric ice mass [kg/m^3]
    rho_n_ice: torch.Tensor   # volumetric ice number [1/m^3]
    F_rim: torch.Tensor       # rime mass fraction
    rho_rim: torch.Tensor     # rime density [kg/m^3]
    rho_g: torch.Tensor       # graupel density [kg/m^3]
    D_th: torch.Tensor
    D_gr: torch.Tensor        # inf when F_rim = 0
    D_cr: torch.Tensor        # inf when F_rim = 0


def p3_state(params: ParametersP3, rho_q_ice, rho_n_ice, F_rim,
             rho_rim) -> P3State:
    dt = float_dtype(rho_q_ice, rho_n_ice, F_rim, rho_rim)
    rho_q_ice, rho_n_ice, F_rim, rho_rim = (
        torch.as_tensor(v, dtype=dt)
        for v in (rho_q_ice, rho_n_ice, F_rim, rho_rim))
    rho_d = get_rho_d(params.mass, F_rim, rho_rim)
    rho_g = get_rho_g(F_rim, rho_rim, rho_d)
    D_th = _threshold(params.mass, params.rho_i) + torch.zeros_like(F_rim)
    unrimed = F_rim == 0
    inf = _full(math.inf, F_rim)
    rho_g_safe = torch.where(unrimed, torch.ones_like(rho_g), rho_g)
    D_gr = torch.where(unrimed, inf, _threshold(params.mass, rho_g_safe))
    D_cr = torch.where(
        unrimed, inf,
        _threshold(params.mass, rho_g_safe * torch.clamp(
            1 - F_rim, min=machine_eps(dt))))
    return P3State(params, rho_q_ice, rho_n_ice, F_rim, rho_rim,
                   rho_g, D_th, D_gr, D_cr)


def state_from_prognostic(params: ParametersP3, rho_q_ice, rho_n_ice,
                          rho_q_rim, rho_b_rim) -> P3State:
    """Regularised state construction from volumetric prognostics
    (reference src/P3_particle_properties.jl:101-106)."""
    dt = float_dtype(rho_q_ice, rho_n_ice, rho_q_rim, rho_b_rim)
    F_rim = torch.clamp(rime_mass_fraction(rho_q_rim, rho_q_ice),
                        max=1 - machine_eps(dt))
    rho_rim = torch.clamp(rime_density(rho_q_rim, rho_b_rim),
                          max=0.8 * params.rho_l)
    return p3_state(params, rho_q_ice, rho_n_ice, F_rim, rho_rim)


def segment_boundaries(state: P3State, D_min=0.0, D_max=math.inf):
    """(D_min, D_th, D_gr, D_cr, D_max) clamped into the window
    (reference src/P3_particle_properties.jl:287-292)."""
    D_min = D_min + torch.zeros_like(state.D_th)
    D_max = D_max + torch.zeros_like(state.D_th)

    def clamp(D):
        return torch.minimum(torch.maximum(D, D_min), D_max)

    return (D_min, clamp(state.D_th), clamp(state.D_gr), clamp(state.D_cr),
            D_max)


def regime_value(state: P3State, D, small, unrimed, dense_rimed, graupel,
                 partially_rimed):
    """Branchless 5-regime select
    (reference src/P3_particle_properties.jl:320-332). The five values may
    be tensors or Python floats."""
    def val(v):
        return torch.as_tensor(v, dtype=D.dtype, device=D.device)

    return torch.where(
        D < state.D_th, val(small),
        torch.where(state.F_rim == 0, val(unrimed),
                    torch.where(D < state.D_gr, val(dense_rimed),
                                torch.where(D < state.D_cr, val(graupel),
                                            val(partially_rimed)))))


def ice_mass_coeffs(state: P3State, D):
    """(a, b) of the regime mass power law ``a D^b``
    (reference src/P3_particle_properties.jl:346-359)."""
    params = state.params
    alpha, beta = params.mass.alpha_va, params.mass.beta_va
    epsB = eps_numerics_P3_B(D.dtype)
    Fu = torch.clamp(1 - state.F_rim, min=epsB)
    a = regime_value(state, D, params.rho_i * PI / 6, alpha, alpha,
                     state.rho_g * PI / 6, alpha / Fu)
    b = regime_value(state, D, 3.0, beta, beta, 3.0, beta)
    return a, b


def ice_mass(state: P3State, D):
    a, b = ice_mass_coeffs(state, D)
    return a * D**b


def ice_density(state: P3State, D):
    return ice_mass(state, D) / CO.volume_sphere_D(D)


def d_ice_mass_dD(state: P3State, D):
    a, b = ice_mass_coeffs(state, D)
    return a * b * D ** (b - 1)


def ice_area(state: P3State, D):
    """Regime cross-sectional area
    (reference src/P3_particle_properties.jl:419-428)."""
    area = state.params.area
    spherical = D**2 * PI / 4
    nonspherical = area.gamma * D**area.sigma
    return regime_value(
        state, D, spherical, nonspherical, nonspherical, spherical,
        weighted_average(state.F_rim, spherical, nonspherical))


def _phi_material_density(state: P3State, D):
    rho_i = state.params.rho_i
    return regime_value(state, D, rho_i, rho_i, rho_i, state.rho_g, rho_i)


def phi_i(state: P3State, D):
    """Oblate aspect ratio ``phi = 3 sqrt(pi) m / (4 rho a^(3/2))``
    (reference src/P3_particle_properties.jl:464-475)."""
    m = ice_mass(state, D)
    a = ice_area(state, D)
    rho = _phi_material_density(state, D)
    a_safe = torch.clamp(a, min=floatmin(D.dtype))
    phi_ob = 3 * math.sqrt(PI) * m / (4 * rho * a_safe * torch.sqrt(a_safe))
    return torch.where(D == 0, torch.zeros_like(phi_ob), phi_ob)


def aspect_ratio_factor(state: P3State, D):
    """Terminal-velocity aspect-ratio factor: ``cbrt(phi_i)`` for Oblate,
    1 otherwise (reference src/P3_integral_properties.jl functors)."""
    if state.params.aspect_ratio == OBLATE:
        return cbrt(phi_i(state, D))
    return torch.ones_like(D)


# ---------------------------------------------------------------------------
# Size distribution (reference src/P3_size_distribution.jl)
# ---------------------------------------------------------------------------

def get_mu(slope, loglambda):
    """mu(lambda) law (reference src/P3_size_distribution.jl:171-173)."""
    if isinstance(slope, SlopePowerLaw):
        return torch.clamp(slope.a * torch.exp(loglambda) ** slope.b
                           - slope.c, 0.0, slope.mu_max)
    if isinstance(slope, SlopeConstant):
        return slope.mu + torch.zeros_like(loglambda)
    raise TypeError(f"unknown slope law {type(slope)}")


def loggamma_inc_moment(D1, D2, mu, loglambda, k=0.0, scale=1.0,
                        lo_is_zero=False, hi_is_inf=False):
    """``log(scale * int_D1^D2 D^(mu+k) e^(-lambda D) dD)`` via regularized
    incomplete gammas in log space
    (reference src/P3_size_distribution.jl:97-109).

    ``lo_is_zero`` / ``hi_is_inf`` are static flags for the outermost
    segments of the full-support mass moment, where ``gamma_inc`` is
    analytic — ``P(z, 0) = 0`` / ``Q(z, inf) = 0`` — and its evaluation is
    skipped."""
    z = k + mu + 1
    one = torch.ones_like(z)
    zero = torch.zeros_like(z)
    if lo_is_zero:
        p1, q1 = zero, one
    else:
        x1 = D1 * torch.exp(loglambda)
        p1, q1 = gamma_inc(z, x1)
    if hi_is_inf:
        p2, q2 = one, zero
        x2 = math.inf + zero
    else:
        x2 = D2 * torch.exp(loglambda)
        p2, q2 = gamma_inc(z, x2)
    dq = torch.where(x2 < z + 1, p2 - p1, q1 - q2)
    dq = torch.clamp(dq, min=machine_eps(z.dtype))
    out = -z * loglambda + lgamma(z) + torch.log(dq) + math.log(scale)
    return torch.where(D1 < D2, out, _full(-math.inf, out))


def gamma_inc_moment(D1, D2, p, alpha):
    """``int_D1^D2 D^p e^(-alpha D) dD`` in linear space
    (reference src/P3_size_distribution.jl:121-133)."""
    dt = float_dtype(D1, D2, alpha)
    z = p + 1
    p1, q1 = gamma_inc(z, alpha * D1)
    x2 = alpha * D2
    p2, q2 = gamma_inc(z, x2)
    dq = torch.clamp(torch.where(x2 < z + 1, p2 - p1, q1 - q2), min=0.0)
    alpha_safe = torch.clamp(alpha, min=floatmin(dt))
    out = gamma(z) * dq / alpha_safe**z
    out = torch.where(D2 > D1, out, torch.zeros_like(out))
    return torch.where(alpha > 0, out, _full(math.nan, out))


def loggamma_moment(mu, loglambda, k=0.0, scale=1.0):
    """``log(scale * int_0^inf D^(mu+k) e^(-lambda D) dD)``
    (reference src/P3_size_distribution.jl:153-157)."""
    z = k + mu + 1
    return -z * loglambda + lgamma(z) + math.log(scale)


def logmass_gamma_moment(state: P3State, mu, loglambda, n=0.0):
    """``log(int_0^inf D^n m(D) G(D) dD)`` — segment-summed via logsumexp
    (reference src/P3_size_distribution.jl:193-200)."""
    bnds = segment_boundaries(state)
    moments = []
    last = len(bnds) - 2
    for i, (D_lo, D_hi) in enumerate(zip(bnds[:-1], bnds[1:])):
        a, b = ice_mass_coeffs(state, (D_lo + D_hi) / 2)
        # the coefficient a folds into log space directly (a > 0); the
        # support is [0, inf), so the outermost gamma_inc endpoint
        # evaluations are analytic (see loggamma_inc_moment)
        m = loggamma_inc_moment(D_lo, D_hi, mu, loglambda, b + n, 1.0,
                                lo_is_zero=(i == 0),
                                hi_is_inf=(i == last)) \
            + torch.log(torch.clamp(a, min=floatmin(a.dtype)))
        # collapsed segments contribute -inf (excluded from logsumexp)
        m = torch.where(D_lo < D_hi, m, _full(-math.inf, m))
        moments.append(m)
    stacked = torch.stack(torch.broadcast_tensors(*moments), dim=-1)
    return logsumexp(stacked, axis=-1)


def logLdivN(state: P3State, loglambda):
    """``log(L/N)`` (reference src/P3_size_distribution.jl:211-216)."""
    mu = get_mu(state.params.slope, loglambda)
    logLdivN0 = logmass_gamma_moment(state, mu, loglambda, n=0.0)
    logNdivN0 = loggamma_moment(mu, loglambda, k=0.0)
    return logLdivN0 - logNdivN0


def get_logN0(N_ice, mu, loglambda):
    """(reference src/P3_size_distribution.jl:233-237)."""
    N_safe = torch.clamp(N_ice, min=floatmin(float_dtype(N_ice, loglambda)))
    return torch.log(N_safe) - loggamma_moment(mu, loglambda, k=0.0)


def log_nprime_ice(state: P3State, loglambda):
    """Return ``(log_N0, mu, lambda)`` of ``log n(D) = log_N0 + mu log D
    - lambda D`` (reference P3LogNumberFunctor)."""
    mu = get_mu(state.params.slope, loglambda)
    log_N0 = get_logN0(state.rho_n_ice, mu, loglambda)
    return log_N0, mu, torch.exp(loglambda)


def size_distribution(state: P3State, loglambda):
    """Return ``n(D)`` as a closure (D may carry a leading node axis)."""
    log_N0, mu, lam = log_nprime_ice(state, loglambda)

    def n(D):
        D_safe = torch.clamp(D, min=floatmin(D.dtype))
        return torch.exp(log_N0 + mu * torch.log(D_safe) - lam * D)

    return n


# ---------------------------------------------------------------------------
# Shape solver (reference src/P3_size_distribution.jl:240-353)
# ---------------------------------------------------------------------------

def _brent_fixed(f, lo, f_lo, hi, f_hi, n_iters: int):
    """Fixed-iteration branchless Brent's method (Press et al. ``zbrent``).

    Runs exactly ``n_iters`` iterations (no early exit, the reference's
    ``FixedIterations`` tolerance) with ``where``-based updates:
    inverse-quadratic / secant interpolation with the Press acceptance
    conditions, falling back to bisection.
    """
    dt = float_dtype(lo, hi)
    eps = machine_eps(dt)
    tiny = floatmin(dt)

    a, fa = lo, f_lo
    b, fb = hi, f_hi
    c, fc = b, fb
    d = b - a
    e = b - a
    for _ in range(n_iters):
        # re-bracket: if fb and fc share a sign, reset c to a
        same_sign = fb * fc > 0
        c = torch.where(same_sign, a, c)
        fc = torch.where(same_sign, fa, fc)
        d = torch.where(same_sign, b - a, d)
        e = torch.where(same_sign, b - a, e)

        # ensure |fc| >= |fb| (b is the best estimate)
        swap = torch.abs(fc) < torch.abs(fb)
        a = torch.where(swap, b, a)
        b = torch.where(swap, c, b)
        c = torch.where(swap, a, c)
        fa = torch.where(swap, fb, fa)
        fb = torch.where(swap, fc, fb)
        fc = torch.where(swap, fa, fc)

        tol1 = 2 * eps * torch.abs(b)
        xm = (c - b) / 2

        # attempt inverse quadratic / secant interpolation
        can_interp = (torch.abs(e) >= tol1) & (torch.abs(fa) > torch.abs(fb))
        fa_safe = torch.where(torch.abs(fa) > 0, fa, _full(tiny, fa))
        fc_safe = torch.where(torch.abs(fc) > 0, fc, _full(tiny, fc))
        s = fb / fa_safe
        secant = a == c
        p_sec = 2 * xm * s
        q_sec = 1 - s
        q_i = fa / fc_safe
        r_i = fb / fc_safe
        p_iqi = s * (2 * xm * q_i * (q_i - r_i) - (b - a) * (r_i - 1))
        q_iqi = (q_i - 1) * (r_i - 1) * (s - 1)
        p = torch.where(secant, p_sec, p_iqi)
        q = torch.where(secant, q_sec, q_iqi)
        q = torch.where(p > 0, -q, q)
        p = torch.abs(p)
        q_safe = torch.where(torch.abs(q) > 0, q, _full(tiny, q))
        accept = can_interp & (
            2 * p < torch.minimum(3 * xm * q - torch.abs(tol1 * q),
                                  torch.abs(e * q)))
        e_new = torch.where(accept, d, xm)
        d_new = torch.where(accept, p / q_safe, xm)

        a, fa = b, fb
        # minimum step of tol1 in the direction of xm
        step = torch.where(torch.abs(d_new) > tol1, d_new,
                           torch.where(xm >= 0, tol1, -tol1))
        b = b + step
        fb = f(b)
        d, e = d_new, e_new
    # the best of the final pair
    return torch.where(torch.abs(fb) <= torch.abs(fc), b, c)


def get_distribution_loglambda(state: P3State, loglambda_guess=None,
                               loglambda_min=2.0, loglambda_max=17.0):
    """Solve ``logLdivN(loglambda) = log(L/N)`` for the PSD slope.

    Fixed-iteration (8 at float32, 10 at float64) branchless Brent over the
    bracket ``[2, 17]``, with optional warm-start bracket narrowing
    (reference src/P3_size_distribution.jl:284-353). Returns ``log(0)``
    (-inf) where ice is absent.
    """
    dt = float_dtype(state.rho_q_ice, state.rho_n_ice)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    empty = (state.rho_n_ice < en) | (state.rho_q_ice < em)

    tiny = floatmin(dt)
    target = torch.log(torch.clamp(state.rho_q_ice, min=tiny)) \
        - torch.log(torch.clamp(state.rho_n_ice, min=tiny))

    def shape_problem(loglam):
        return logLdivN(state, loglam) - target

    lo = loglambda_min + torch.zeros_like(target)
    hi = loglambda_max + torch.zeros_like(target)
    f_lo = shape_problem(lo)
    f_hi = shape_problem(hi)

    # degenerate bracket -> nearest endpoint
    degenerate = ~torch.isfinite(f_lo) | ~torch.isfinite(f_hi) \
        | (f_lo * f_hi > 0)
    endpoint = torch.where(torch.abs(f_lo) <= torch.abs(f_hi), lo, hi)

    # warm-start narrowing (reference :336-353)
    if loglambda_guess is not None:
        p = torch.as_tensor(loglambda_guess, dtype=dt,
                            device=lo.device) + torch.zeros_like(lo)
        valid = torch.isfinite(p) & (lo < p) & (p < hi)
        p_clean = torch.where(valid, p, lo)
        f_p = shape_problem(p_clean)
        valid = valid & torch.isfinite(f_p)
        left = valid & (f_lo * f_p < 0)
        right = valid & ~left
        hi = torch.where(left, p_clean, hi)
        f_hi = torch.where(left, f_p, f_hi)
        lo = torch.where(right, p_clean, lo)
        f_lo = torch.where(right, f_p, f_lo)

    n_iters = 10 if dt == torch.float64 else 8
    root = _brent_fixed(shape_problem, lo, f_lo, hi, f_hi, n_iters)
    root = torch.where(degenerate, endpoint, root)
    return torch.where(empty, _full(-math.inf, root), root)


def get_distribution_loglambda_from_prognostic(
        params: ParametersP3, rho_q_ice, rho_n_ice, rho_q_rim, rho_b_rim,
        loglambda_guess=None):
    """Shape solve directly from volumetric prognostics: sugar over
    :func:`state_from_prognostic` + :func:`get_distribution_loglambda`
    (reference src/P3_size_distribution.jl
    ``get_distribution_logλ_from_prognostic``)."""
    state = state_from_prognostic(params, rho_q_ice, rho_n_ice,
                                  rho_q_rim, rho_b_rim)
    return get_distribution_loglambda(state, loglambda_guess)


def get_distribution_loglambda_all_solutions(state: P3State,
                                             n_scan: int = 401):
    """All candidate ``loglambda`` roots of the shape problem
    (reference src/P3_size_distribution.jl:365-384; experimental: only the
    SlopePowerLaw mu(lambda) law can be multi-rooted).

    ``logLdivN`` is evaluated on an ``n_scan``-point grid over
    ``lambda in [1e2, 1e6]``, and the fixed-iteration Brent solver runs on
    every adjacent pair, with non-bracketing pairs masked to NaN. Returns
    an ``(n_scan - 1, *cell)`` tensor of roots (the JAX package's ``vmap``
    over the grid is a leading axis here)."""
    dt = float_dtype(state.rho_q_ice, state.rho_n_ice)
    tiny = floatmin(dt)
    target = torch.log(torch.clamp(state.rho_q_ice, min=tiny)) \
        - torch.log(torch.clamp(state.rho_n_ice, min=tiny))

    # jnp.linspace(2, 6, n_scan) as JAX forms it in float64,
    # start (1 - i/div) + stop i/div with the end point appended
    div = n_scan - 1
    step = torch.arange(div, dtype=torch.float64) / div
    unit = torch.cat([2.0 * (1 - step) + 6.0 * step,
                      torch.full((1,), 6.0, dtype=torch.float64)])
    grid = (math.log(10.0) * unit).to(dtype=dt, device=target.device)
    grid = grid.reshape((n_scan,) + (1,) * target.dim())

    f = logLdivN(state, grid) - target
    lo, hi = grid[:-1], grid[1:]
    bracketed = f[:-1] * f[1:] < 0
    roots = get_distribution_loglambda(state, loglambda_min=lo,
                                       loglambda_max=hi)
    return torch.where(bracketed, roots, _full(math.nan, roots))


# ---------------------------------------------------------------------------
# Integral properties (reference src/P3_integral_properties.jl)
# ---------------------------------------------------------------------------

def integral_bounds(state: P3State, loglambda, p, moment_order=0.0):
    """Quantile-based integration bounds clamped through the segment
    boundaries (reference src/P3_integral_properties.jl:34-45).

    The two tail probabilities are tensors of ``loglambda``'s dtype, so
    their complements ``1 - p`` round in that dtype, as in the JAX
    package."""
    from ..utils.distributions import generalized_gamma_quantile_unit_mu

    def prob(v):
        return torch.tensor(v, dtype=loglambda.dtype, device=loglambda.device)

    k = get_mu(state.params.slope, loglambda) + moment_order
    lam = torch.exp(loglambda)
    # 4 Halley steps: tail-window bounds need far less precision than the
    # quadrature truncation error they control (see gamma_inc_inv)
    D_min = generalized_gamma_quantile_unit_mu(k, lam, prob(p), n_iters=4)
    D_max = generalized_gamma_quantile_unit_mu(k, lam, prob(1 - p),
                                               n_iters=4)
    return segment_boundaries(state, D_min, D_max)


def D_m(state: P3State, loglambda):
    """Mass-weighted mean particle size [m]
    (reference src/P3_integral_properties.jl:56-61)."""
    mu = get_mu(state.params.slope, loglambda)
    mw = logmass_gamma_moment(state, mu, loglambda, n=1.0)
    log_N0 = get_logN0(state.rho_n_ice, mu, loglambda)
    q_safe = torch.clamp(state.rho_q_ice, min=floatmin(loglambda.dtype))
    return torch.exp(log_N0 + mw) / q_safe


# ---------------------------------------------------------------------------
# Shared quadrature-node context
# ---------------------------------------------------------------------------

class IceQuadNodes(NamedTuple):
    """Ice PSD quadrature nodes with the two expensive per-node fields
    evaluated once: the piecewise Chen2022 terminal velocity and the size
    distribution. Every bulk ice integral of a P3 step (liquid-ice
    collisions, ice self-collection, melt, the weighted fall speeds)
    contracts against this same node axis."""

    D: torch.Tensor     # (n_segments * n_quad, *cell) segment-concatenated
    w: torch.Tensor     # matching weights (zero on collapsed segments)
    v: torch.Tensor     # terminal velocity at D [m/s]
    n: torch.Tensor     # size distribution at D [1/m^4]
    nw: torch.Tensor    # n * w: every bulk contraction uses this product
    bnds: tuple         # the (D_min, D_th, D_gr, D_cr, D_max) window


def ice_quadrature_nodes(velocity_params: Chen2022VelType, rho_a,
                         state: P3State, loglambda, p=1e-6,
                         quad: Optional[QuadratureRule] = None
                         ) -> IceQuadNodes:
    """Build the shared per-step ice node context (tail quantile ``p``)."""
    from ..utils.quadrature import segment_nodes

    if quad is None:
        quad = default_quadrature()
    bnds = integral_bounds(state, loglambda, p)
    D, w = segment_nodes(quad, bnds)
    v = ice_particle_terminal_velocity(velocity_params, rho_a, state)(D)
    n = size_distribution(state, loglambda)(D)
    return IceQuadNodes(D=D, w=w, v=v, n=n, nw=n * w, bnds=bnds)


# ---------------------------------------------------------------------------
# Terminal velocity (reference src/P3_terminal_velocity.jl)
# ---------------------------------------------------------------------------

# the ice density of the Chen 2022 ice velocity: the reference's hardcoded
# value (src/P3_terminal_velocity.jl:100)
ICE_VELOCITY_RHO_I = 916.7


def ice_particle_terminal_velocity(velocity_params: Chen2022VelType, rho_a,
                                   state: P3State):
    """Return ``v(D)``: piecewise small/large Chen2022 ice velocity times
    the aspect-ratio factor (reference src/P3_terminal_velocity.jl:12-45)."""
    aiu_s, bi_s, ciu_s = CO.chen2022_vel_coeffs_small_ice(
        velocity_params.small_ice, rho_a, ICE_VELOCITY_RHO_I)
    aiu_l, bi_l, ciu_l = CO.chen2022_vel_coeffs_large_ice(
        velocity_params.large_ice, rho_a, ICE_VELOCITY_RHO_I)
    cutoff = velocity_params.small_ice.cutoff

    def v_term(D):
        v_small = CO.chen2022_velocity_sum(aiu_s, bi_s, ciu_s, D)
        v_large = CO.chen2022_velocity_sum(aiu_l, bi_l, ciu_l, D)
        v = torch.where(D <= cutoff, v_small, v_large)
        return v * aspect_ratio_factor(state, D)

    return v_term


def _weighted_velocity(velocity_params, rho_a, state, loglambda, p, quad,
                       mass_weighted: bool, nodes=None):
    dt = float_dtype(rho_a, loglambda)
    eps = machine_eps(dt)
    empty = (state.rho_n_ice < eps) | (state.rho_q_ice < eps)

    if nodes is None:
        nodes = ice_quadrature_nodes(velocity_params, rho_a, state,
                                     loglambda, p, quad)

    integrand = nodes.nw * nodes.v
    if mass_weighted:
        integrand = integrand * ice_mass(state, nodes.D)
        denom = state.rho_q_ice
    else:
        denom = state.rho_n_ice

    val = sum_nodes(integrand)
    out = val / torch.clamp(denom, min=floatmin(dt))
    return torch.where(empty, torch.zeros_like(out), out)


def ice_terminal_velocity_number_weighted(
    velocity_params: Chen2022VelType, rho_a, state: P3State, loglambda,
    p=1e-6, quad: Optional[QuadratureRule] = None,
    nodes: Optional[IceQuadNodes] = None,
):
    """Number-weighted bulk ice fall speed by quadrature
    (reference src/P3_terminal_velocity.jl:73-135). Pass ``nodes`` to
    reuse a step-shared :class:`IceQuadNodes` (``p``/``quad`` ignored)."""
    if quad is None:
        quad = default_quadrature()
    return _weighted_velocity(velocity_params, rho_a, state, loglambda, p,
                              quad, mass_weighted=False, nodes=nodes)


def ice_terminal_velocity_mass_weighted(
    velocity_params: Chen2022VelType, rho_a, state: P3State, loglambda,
    p=1e-6, quad: Optional[QuadratureRule] = None,
    nodes: Optional[IceQuadNodes] = None,
):
    """Mass-weighted bulk ice fall speed by quadrature."""
    if quad is None:
        quad = default_quadrature()
    return _weighted_velocity(velocity_params, rho_a, state, loglambda, p,
                              quad, mass_weighted=True, nodes=nodes)
