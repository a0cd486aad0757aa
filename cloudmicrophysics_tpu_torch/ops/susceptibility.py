"""Precipitation susceptibility: d ln(process) / d ln(q, N).

Port of ``cloudmicrophysics_tpu/ops/susceptibility.py`` (reference
``src/PrecipitationSusceptibility.jl``, which takes ForwardDiff gradients
in log space). The JAX package takes ``jax.grad`` of the log-rate of
scalar inputs; here ``torch.autograd.grad`` of the log-rate summed over
the elements gives the same derivatives, because the rate is point-wise.
The inputs are taken in float64, as the JAX package takes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parameters import m2 as P2
from . import m2 as CM2

__all__ = [
    "PrecipSusceptibilityRates",
    "precipitation_susceptibility_autoconversion",
    "precipitation_susceptibility_accretion",
]


class PrecipSusceptibilityRates(NamedTuple):
    d_ln_pp_d_ln_q_lcl: torch.Tensor
    d_ln_pp_d_ln_q_rai: torch.Tensor
    d_ln_pp_d_ln_N_lcl: torch.Tensor
    d_ln_pp_d_ln_N_rai: torch.Tensor


def _log_susceptibility(rate_fn, q_lcl, q_rai, rho, N_lcl):
    """Gradient of log(rate) wrt log of each (positive) argument."""
    logs = torch.stack(torch.broadcast_tensors(*(
        torch.log(torch.abs(torch.as_tensor(v).to(torch.float64)))
        for v in (q_lcl, q_rai, rho, N_lcl))))
    x = logs.detach().requires_grad_(True)
    with torch.enable_grad():
        e = torch.exp(x)
        out = torch.log(rate_fn(e[0], e[1], e[2], e[3]))
        (grad,) = torch.autograd.grad(out.sum(), x)
    return PrecipSusceptibilityRates(
        d_ln_pp_d_ln_q_lcl=grad[0],
        d_ln_pp_d_ln_q_rai=grad[1],
        d_ln_pp_d_ln_N_lcl=grad[3],
        d_ln_pp_d_ln_N_rai=torch.zeros_like(grad[0]),
    )


def precipitation_susceptibility_autoconversion(sb: P2.SB2006, q_lcl, q_rai,
                                                rho, N_lcl):
    """Log-derivatives of the SB2006 autoconversion rain production
    (reference src/PrecipitationSusceptibility.jl:36-51)."""
    return _log_susceptibility(
        lambda ql, qr, r, nl: CM2.autoconversion(
            sb.acnv, sb.pdf_c, ql, qr, r, nl).dq_rai_dt,
        q_lcl, q_rai, rho, N_lcl)


def precipitation_susceptibility_accretion(sb: P2.SB2006, q_lcl, q_rai,
                                           rho, N_lcl):
    """Log-derivatives of the SB2006 accretion rain production
    (reference src/PrecipitationSusceptibility.jl:66-79)."""
    return _log_susceptibility(
        lambda ql, qr, r, nl: CM2.accretion(sb, ql, qr, r, nl).dq_rai_dt,
        q_lcl, q_rai, rho, N_lcl)
