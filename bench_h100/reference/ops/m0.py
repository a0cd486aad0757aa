"""0-moment bulk microphysics (threshold relaxation removal).

Port of ``cloudmicrophysics_tpu/ops/m0.py`` (reference
``src/Microphysics0M.jl``).
"""

from __future__ import annotations

import torch

from ..parameters.common import Parameters0M

__all__ = [
    "remove_precipitation",
    "d_remove_precipitation_dq_tot",
]


def remove_precipitation(params: Parameters0M, q_lcl, q_icl, q_vap_sat=None):
    """Total-water tendency from precipitation removal [kg/kg/s].

    Relaxation with constant timescale toward condensate at threshold;
    threshold is ``qc_0`` (3-arg form) or ``S_0 * q_vap_sat`` (4-arg form)
    (reference ``src/Microphysics0M.jl:35-46``).
    """
    threshold = params.qc_0 if q_vap_sat is None else params.S_0 * q_vap_sat
    excess = q_lcl + q_icl - threshold
    return -torch.clamp(excess, min=0.0) / params.tau_precip


def d_remove_precipitation_dq_tot(params: Parameters0M, q_lcl, q_icl,
                                  q_vap_sat=None):
    """Analytic derivative wrt q_tot: -1/tau when removal is active
    (reference ``src/Microphysics0M.jl:64-75``)."""
    threshold = params.qc_0 if q_vap_sat is None else params.S_0 * q_vap_sat
    active = q_lcl + q_icl > threshold
    out = torch.full_like(q_lcl, -1.0 / params.tau_precip)
    return torch.where(active, out, torch.zeros_like(out))
