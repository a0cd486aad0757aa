"""State containers shared by the scheme modules.

The reference passes per-cell state as named tuples ``micro = (; q_tot,
q_lcl, q_icl, q_rai, q_sno)`` and ``thermo = (; rho, T)`` (see
``src/BulkMicrophysicsTendencies.jl:141-217``). Here they are typed
NamedTuples of tensors of one shared shape; every rate is elementwise
over them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MicroState(NamedTuple):
    """Specific contents [kg/kg]: total, cloud liquid, cloud ice, rain, snow."""

    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    q_icl: torch.Tensor
    q_rai: torch.Tensor
    q_sno: torch.Tensor


class ThermoState(NamedTuple):
    """Air density [kg/m^3] and temperature [K]."""

    rho: torch.Tensor
    T: torch.Tensor


class MicroState2M(NamedTuple):
    """2-moment prognostics: specific contents [kg/kg] + number
    concentrations [1/kg]."""

    q_tot: torch.Tensor
    q_lcl: torch.Tensor
    q_rai: torch.Tensor
    n_lcl: torch.Tensor
    n_rai: torch.Tensor
