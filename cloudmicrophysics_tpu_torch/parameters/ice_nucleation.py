"""Ice nucleation parameters (the part the 1M scheme needs).

Reference: ``src/parameters/IceNucleation.jl``. Only
:class:`Frostenberg2023` is ported so far: the 1M ``TemperatureDependent``
cloud-ice formation option reads it. The other nucleation structs come
with the nucleation ops.
"""

from __future__ import annotations

import math

from ..utils.param import paramclass


@paramclass
class Frostenberg2023:
    """INP concentration distribution vs temperature (Frostenberg et al. 2023,
    doi:10.5194/acp-23-10883-2023; reference
    src/parameters/IceNucleation.jl:178-200).

    At the defaults ``a = b = 1`` the mean log-INPC reduces to the marine
    dataset curve ``log((-T_celsius/10)^9)``.
    """

    sigma: float = 1.37     # standard deviation of log(INPC)
    a: float = 1.0
    b: float = 1.0
    T_freeze: float = 273.15

    @property
    def log_a(self) -> float:
        return math.log(self.a)
