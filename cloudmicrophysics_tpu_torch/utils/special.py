"""Small-number utilities and elementwise special functions (L0).

Port of ``cloudmicrophysics_tpu/utils/special.py:70-560``: the dtype
helpers, the two-tier smallness thresholds (reference
``src/Utilities.jl:254-341``), the elementwise functions the process
rates use, and the fixed-iteration regularized incomplete gamma and its
inverse (reference ``src/Utilities.jl:33-252``). The JAX package builds
``expm1``/``atanh``/``lgamma`` from the primitives a TPU kernel can lower;
here they are PyTorch's own, except the Lanczos ``_lgamma_pos`` that
:func:`gamma_inc` uses, as the JAX package's does.

The module ends with ``logsumexp`` and the regularised ratios the P3 state
reads (``cloudmicrophysics_tpu/utils/special.py:569-633``).

Forward only: the JAX package's ``custom_jvp`` rules of :func:`gamma_inc`
and :func:`gamma_inc_inv` (closed-form derivative in ``x``/``p``, NaN for
a tangent in ``a``) are not ported yet.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "atanh",
    "cbrt",
    "clamp_to_nonneg",
    "eps_numerics",
    "eps_numerics_2M_M",
    "eps_numerics_2M_N",
    "eps_numerics_P3_B",
    "expm1",
    "fac",
    "float_dtype",
    "floatmin",
    "gamma",
    "gamma_inc",
    "gamma_inc_inv",
    "gamma_inc_lower",
    "gamma_inc_upper",
    "lgamma",
    "logsumexp",
    "machine_eps",
    "regularised_ratio",
    "rime_density",
    "rime_mass_fraction",
    "sgs_weight_function",
]


def float_dtype(*args) -> torch.dtype:
    """The common floating dtype of the tensor arguments.

    Python numbers do not take part (as JAX's weak types do not); with no
    floating tensor among the arguments the result is float64, the dtype of
    a Python float.
    """
    dtypes = [a.dtype for a in args if isinstance(a, torch.Tensor)]
    if dtypes:
        dt = functools.reduce(torch.promote_types, dtypes)
        if dt.is_floating_point:
            return dt
    return torch.float64


def machine_eps(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).eps)


def floatmin(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).tiny)


def eps_numerics(dt: torch.dtype) -> float:
    """1-moment presence threshold: ``cbrt(floatmin)`` (~2.3e-13 @ f32)."""
    return float(floatmin(dt) ** (1.0 / 3.0))


def eps_numerics_2M_M(dt: torch.dtype) -> float:
    """2-moment mass presence threshold: machine eps."""
    return machine_eps(dt)


def eps_numerics_2M_N(dt: torch.dtype) -> float:
    """2-moment number presence threshold: machine eps."""
    return machine_eps(dt)


def eps_numerics_P3_B(dt: torch.dtype) -> float:
    """P3 rime-volume (B_rim) presence threshold: machine eps."""
    return machine_eps(dt)


def clamp_to_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Domain sanitization (NOT a physical threshold): ``max(x, 0)``."""
    return torch.clamp(x, min=0.0)


def fac(n: int) -> int:
    """Integer factorial, host-side (reference src/Utilities.jl:299-308)."""
    if not 0 <= n <= 20:
        raise ValueError(f"fac(n) is defined for 0 <= n <= 20, got {n}")
    return math.factorial(n)


def expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.expm1(x)


def atanh(x: torch.Tensor) -> torch.Tensor:
    return torch.atanh(x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Signed cube root."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def lgamma(a):
    """``log Gamma(a)``; a Python number is evaluated on the host, so a
    parameter-only factor stays a Python float."""
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return math.lgamma(a)
    return torch.lgamma(a)


def gamma(a):
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return math.exp(math.lgamma(a))
    return torch.exp(torch.lgamma(a))


# Lanczos g=7, n=9 coefficients, as the JAX package's utils/special.py
_LANCZOS_G = 7.0
_LANCZOS_COEFFS = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _lgamma_pos(z: torch.Tensor) -> torch.Tensor:
    """``log Gamma(z)`` for ``z > 0`` by the Lanczos series (abs err ~1e-13
    in float64); ``z <= 0`` is sanitized, not NaN."""
    z = torch.clamp(z, min=floatmin(z.dtype)) - 1
    series = torch.full_like(z, _LANCZOS_COEFFS[0])
    for i, c in enumerate(_LANCZOS_COEFFS[1:], start=1):
        series = series + c / (z + i)
    t = z + _LANCZOS_G + 0.5
    return _HALF_LOG_2PI + (z + 0.5) * torch.log(t) - t + torch.log(series)


# ---------------------------------------------------------------------------
# Incomplete gamma: fixed-iteration series + Lentz continued fraction
# ---------------------------------------------------------------------------

def _maxiters(dt: torch.dtype) -> int:
    # Reference: 20 iterations for Float32, 30 for Float64
    # (src/Utilities.jl:103)
    return 30 if dt == torch.float64 else 20


def _as_tensors(*args):
    """The arguments as tensors of their common float dtype, on the device
    of the first tensor among them, broadcast to one shape."""
    dt = float_dtype(*args)
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    return torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=dt, device=device) for a in args))


def _gamma_inc_core(a, x, lgamma_a):
    """Both-branch evaluation of (P, Q); inputs share one float dtype."""
    dt = a.dtype
    n = _maxiters(dt)
    tiny = 1e-30
    tmin = floatmin(dt)

    use_series = x < a + 1

    # factor = x^a e^-x / Gamma(a), via logs for stability
    factor = torch.exp(a * torch.log(torch.clamp(x, min=tmin)) - x
                       - lgamma_a)

    # series branch, P(a,x) = factor * sum_k x^k / (a+1)...(a+k); where the
    # continued fraction is taken, it runs on x_s = a (inside its domain)
    # so the discarded values stay finite
    x_s = torch.where(use_series, x, a)
    a_safe = torch.clamp(a, min=tmin)
    term = 1.0 / a_safe
    sum_p = term
    for k in range(1, n + 1):
        term = term * x_s / (a_safe + k)
        sum_p = sum_p + term
    P_series = torch.clamp(factor * sum_p, 0.0, 1.0)

    # continued fraction (Lentz) branch, Q(a,x); where the series is taken
    # it runs on x_c = a + 2, which keeps b_k positive
    x_c = torch.where(use_series, a + 2, x)
    b1 = x_c + 1 - a
    c = b1 + 1 / tiny
    d = 1 / torch.where(torch.abs(b1) < tiny, torch.full_like(b1, tiny), b1)
    h = d
    for k in range(1, n + 1):
        ak = -k * (k - a)
        bk = x_c + 2 * k + 1 - a
        d_tmp = bk + ak * d
        d = torch.where(torch.abs(d_tmp) < tiny, torch.full_like(d_tmp, tiny),
                        d_tmp)
        c_tmp = bk + ak / c
        c = torch.where(torch.abs(c_tmp) < tiny, torch.full_like(c_tmp, tiny),
                        c_tmp)
        d = 1 / d
        h = h * (c * d)
    Q_cf = torch.clamp(factor * h, 0.0, 1.0)

    P = torch.where(use_series, P_series, 1 - Q_cf)
    Q = torch.where(use_series, 1 - P_series, Q_cf)

    # edge cases (reference src/Utilities.jl:94-98)
    zero, one = torch.zeros_like(P), torch.ones_like(P)
    P = torch.where(x <= 0, zero, P)
    Q = torch.where(x <= 0, one, Q)
    P = torch.where(torch.isposinf(x), one, P)
    Q = torch.where(torch.isposinf(x), zero, Q)
    nan = torch.full_like(P, math.nan)
    isnan = torch.isnan(x) | torch.isnan(a)
    return torch.where(isnan, nan, P), torch.where(isnan, nan, Q)


def gamma_inc(a, x):
    """Regularized incomplete gamma ``(P(a,x), Q(a,x))``.

    Fixed-iteration (20 at float32, 30 at float64) series / Lentz continued
    fraction, both evaluated and selected elementwise (reference
    ``src/Utilities.jl:93-144``).
    """
    a, x = _as_tensors(a, x)
    return _gamma_inc_core(a, x, _lgamma_pos(a))


def gamma_inc_lower(a, x):
    """Lower regularized incomplete gamma ``P(a, x)``."""
    return gamma_inc(a, x)[0]


def gamma_inc_upper(a, x):
    """Upper regularized incomplete gamma ``Q(a, x)``."""
    return gamma_inc(a, x)[1]


# ---------------------------------------------------------------------------
# Inverse incomplete gamma: Halley iteration
# ---------------------------------------------------------------------------

_HALLEY_ITERS = 15  # reference src/Utilities.jl:225


def _poly(cs, x):
    r = torch.zeros_like(x) + cs[0]
    for ci in cs[1:]:
        r = r * x + ci
    return r


def _ndtri_acklam(p: torch.Tensor) -> torch.Tensor:
    """Standard-normal inverse CDF, Acklam's rational approximation
    (max |rel err| ~1.15e-9): central region and two tails."""
    a_ = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
    b_ = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
    c_ = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
    d_ = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
    dt = p.dtype
    p_c = torch.clamp(p, floatmin(dt), 1 - machine_eps(dt))
    # central region
    qc = p_c - 0.5
    r = qc * qc
    x_mid = qc * _poly(a_, r) / (_poly(b_, r) * r + 1)
    # lower tail
    fill = torch.full_like(p_c, 0.01)
    ql = torch.sqrt(-2 * torch.log(torch.where(p_c < 0.02425, p_c, fill)))
    x_lo = _poly(c_, ql) / (_poly(d_, ql) * ql + 1)
    # upper tail
    qu = torch.sqrt(-2 * torch.log(torch.where(p_c > 1 - 0.02425, 1 - p_c,
                                               fill)))
    x_hi = -_poly(c_, qu) / (_poly(d_, qu) * qu + 1)
    return torch.where(p_c < 0.02425, x_lo,
                       torch.where(p_c > 1 - 0.02425, x_hi, x_mid))


def gamma_inc_inv(a, p, q, n_iters: int = _HALLEY_ITERS):
    """Inverse of :func:`gamma_inc`: ``x`` such that ``P(a,x) = p``.

    Halley's method, ``n_iters`` fixed iterations with convergence freezing
    (reference ``src/Utilities.jl:205-252``), from the series-inversion
    start where it lands below 1/2 and the Wilson-Hilferty start otherwise
    (the asymptotic tail inversion for ``q`` below ~1e-27), as the JAX
    package does. The ``Q - q`` residual is used for ``p > 0.5``.
    """
    a, p, q = _as_tensors(a, p, q)
    dt = a.dtype
    tiny = floatmin(dt)
    eps = machine_eps(dt)

    p_safe = torch.clamp(p, min=tiny)
    q_safe = torch.clamp(q, min=tiny)
    lgamma_a = _lgamma_pos(a)
    a_safe = torch.clamp(a, min=tiny)
    guess_lo = torch.exp((torch.log(p_safe) + _lgamma_pos(a + 1)) / a_safe)
    z = -_ndtri_acklam(q_safe)
    t_wh = 1 - 1 / (9 * a_safe) + z / (3 * torch.sqrt(a_safe))
    guess_ref = a - torch.log(q_safe)
    guess_hi = torch.where(t_wh > 0.1, a * t_wh**3, guess_ref)
    L_tail = -torch.log(q_safe)
    guess_tail = L_tail + (a - 1) * torch.log(torch.clamp(L_tail, min=1.0)) \
        - lgamma_a
    deep_tail = (L_tail > 60.0) & (guess_tail > 3 * a)
    guess_hi = torch.where(deep_tail, torch.clamp(guess_tail, min=tiny),
                           guess_hi)
    x = torch.where((p < 0.5) | (guess_lo < 0.5), guess_lo, guess_hi)
    x = torch.clamp(x, min=tiny)

    use_q = p > 0.5
    one = torch.ones_like(x)
    done = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(n_iters):
        P, Q = _gamma_inc_core(a, x, lgamma_a)
        f = torch.where(use_q, Q - q, P - p)
        x_pos = torch.clamp(x, min=tiny)
        fprime_mag = torch.exp((a - 1) * torch.log(x_pos) - x - lgamma_a)
        fprime = torch.where(use_q, -fprime_mag, fprime_mag)
        fp_zero = fprime == 0
        fprime_safe = torch.where(fp_zero, one, fprime)
        # f''/f' = (a - 1 - x)/x (sign-independent of residual choice)
        f2_over_f1 = (a - 1 - x) / x_pos
        denom = 1 - 0.5 * f / fprime_safe * f2_over_f1
        step = f / (fprime_safe * denom)
        # protect against stepping to x <= 0
        step = torch.where(x - step <= 0, 0.5 * x, step)
        x_new = x - step
        done_pre = done | fp_zero
        x = torch.where(done_pre, x, x_new)
        done = done_pre | (torch.abs(step) < eps * x_new)

    x = torch.where(p <= 0, torch.zeros_like(x), x)
    x = torch.where(q <= 0, torch.full_like(x, math.inf), x)
    isnan = torch.isnan(a) | torch.isnan(p) | torch.isnan(q)
    return torch.where(isnan, torch.full_like(x, math.nan), x)


# ---------------------------------------------------------------------------
# logsumexp over one axis (reference: unrolled_logsumexp over tuples)
# ---------------------------------------------------------------------------

def logsumexp(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Shift-by-max ``log(sum(exp(x)))`` along ``axis``.

    Non-finite maxima pass through directly (avoids Inf - Inf; reference
    ``src/Utilities.jl:399-412``). The sum runs over the axis in order, one
    addition at a time, so a kernel that adds the same terms in the same
    order rounds alike.
    """
    xmax = torch.amax(x, dim=axis)
    finite = torch.isfinite(xmax)
    shift = torch.where(finite, xmax, torch.zeros_like(xmax))
    terms = torch.exp(x - shift.unsqueeze(axis)).unbind(axis)
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return torch.where(finite, shift + torch.log(s), xmax)


# ---------------------------------------------------------------------------
# SGS weight function + regularised ratios (reference src/Utilities.jl:415-509)
# ---------------------------------------------------------------------------

def sgs_weight_function(a: torch.Tensor, a_half: float) -> torch.Tensor:
    """Smooth monotone weight ``w(a)`` in [0, 1] with ``w(a_half) = 1/2``:
    a ``tanh`` of ``atanh`` sigmoid with midpoint control (reference
    ``src/Utilities.jl:445-457``). ``a_half`` is a Python float, so the
    exponent ``k`` is folded on the host in float64."""
    eps = machine_eps(a.dtype)
    upper = min(1.0 - eps, 42.0 * a_half)
    a_s = torch.clamp(a, eps, upper)
    k = -1.0 / math.log2(1.0 - a_half)
    inner = 1 - 2 * (1 - a_s) ** k
    inner = torch.clamp(inner, -1.0 + eps, 1.0 - eps)
    w = (1 + torch.tanh(2 * torch.atanh(inner))) / 2
    w = torch.where(a < 0, torch.zeros_like(w), w)
    w = torch.where(4 * a < eps, torch.zeros_like(w), w)
    return torch.where(a > min(1.0, 42.0 * a_half), torch.ones_like(w), w)


def regularised_ratio(numerator, denominator, half=None, eps=None):
    """``numerator / denominator`` blended smoothly to 0 for small
    denominators (reference ``src/Utilities.jl:469-479``)."""
    dt = float_dtype(numerator, denominator)
    if half is None:
        half = machine_eps(dt)
    if eps is None:
        eps = machine_eps(dt) ** 2
    w = sgs_weight_function(denominator, half)
    small = denominator < eps
    denom_safe = torch.where(small, torch.ones_like(denominator), denominator)
    out = w * numerator / denom_safe
    return torch.where(small, torch.zeros_like(out), out)


def rime_mass_fraction(q_rim, q_ice, half=None, eps=None):
    """Regularised ``F_rim = q_rim / q_ice`` clamped to [0, 1]."""
    return regularised_ratio(torch.minimum(q_rim, q_ice), q_ice, half, eps)


def rime_density(q_rim, b_rim, half=None, eps=None):
    """Regularised ``rho_rim = q_rim / b_rim``."""
    return regularised_ratio(q_rim, b_rim, half, eps)
