"""Size-distribution tools (generalized gamma + exponential).

Port of ``cloudmicrophysics_tpu/utils/distributions.py`` (reference
``src/DistributionTools.jl``): closed-form quantiles, CDFs and moments used
by the 2-moment scheme and the P3 integral bounds.
"""

from __future__ import annotations

import math

import torch

from .special import expm1, fac, float_dtype, gamma_inc, gamma_inc_inv, lgamma

__all__ = [
    "generalized_gamma_quantile",
    "generalized_gamma_quantile_unit_mu",
    "generalized_gamma_cdf",
    "generalized_gamma_moment",
    "exponential_cdf",
    "exponential_quantile",
    "exponential_moment",
]


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """Stable ``log(1 - exp(x))`` for ``x <= 0``; ``-inf`` for
    ``x > -2 * tiny``, where ``1 - exp(x)`` is zero or subnormal (the JAX
    package's tanh-based ``expm1`` flushes it to zero there, so
    ``exponential_cdf(0)`` is exactly 0)."""
    tiny = torch.finfo(float_dtype(x)).tiny
    x_hi = torch.clamp(x, max=-tiny)
    out = torch.where(x > -math.log(2.0), torch.log(-expm1(x_hi)),
                      torch.log1p(-torch.exp(x_hi)))
    return torch.where(x > -2 * tiny, torch.full_like(out, -math.inf), out)


def generalized_gamma_quantile(nu, mu, B, Y, n_iters=None):
    """Quantile of ``g(x) = A x^nu exp(-B x^mu)``
    (reference ``src/DistributionTools.jl:44-48``).

    ``n_iters`` forwards to :func:`gamma_inc_inv`: integration-bound call
    sites pass a reduced Halley count."""
    kw = {} if n_iters is None else {"n_iters": n_iters}
    z = gamma_inc_inv((nu + 1) / mu, Y, 1 - Y, **kw)
    return (z / B) ** (1 / mu)


def generalized_gamma_quantile_unit_mu(nu, B, Y, n_iters=None):
    """The ``mu == 1`` case (reference ``src/DistributionTools.jl:57-58``)."""
    kw = {} if n_iters is None else {"n_iters": n_iters}
    return gamma_inc_inv(nu + 1, Y, 1 - Y, **kw) / B


def generalized_gamma_cdf(nu, mu, B, x):
    """CDF ``P(X <= x)`` of the generalized gamma distribution
    (reference ``src/DistributionTools.jl:77-87``)."""
    x_safe = torch.clamp(x, min=0.0)
    p, _ = gamma_inc((nu + 1) / mu, B * x_safe**mu)
    return torch.where(x <= 0, torch.zeros_like(p), p)


def generalized_gamma_moment(nu, mu, B, N, n):
    """n-th physical moment ``M^n = N B^(-n/mu) G((nu+1+n)/mu)/G((nu+1)/mu)``
    (SB2006 Eq 82; reference ``src/DistributionTools.jl:109-112``)."""
    log_ratio = lgamma((nu + 1 + n) / mu) - lgamma((nu + 1) / mu)
    ratio = (torch.exp(log_ratio) if isinstance(log_ratio, torch.Tensor)
             else math.exp(log_ratio))
    return N * B ** (-n / mu) * ratio


def exponential_cdf(D_mean, D):
    """CDF of ``n(D) = N0 exp(-D/D_mean)``
    (reference ``src/DistributionTools.jl:131-139``)."""
    p = torch.exp(log1mexp(-D / D_mean))
    return torch.where(D < 0, torch.zeros_like(p), p)


def exponential_quantile(D_mean, Y):
    """Quantile ``D = -D_mean log(1 - Y)``
    (reference ``src/DistributionTools.jl:158-165``)."""
    log1p = (torch.log1p(-Y) if isinstance(Y, torch.Tensor)
             else math.log1p(-Y))
    return -D_mean * log1p


def exponential_moment(D_mean, N, n: int):
    """n-th moment ``M^n = N n! D_mean^n``
    (reference ``src/DistributionTools.jl:189-191``)."""
    return N * fac(n) * D_mean**n
