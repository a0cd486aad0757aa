"""The benchmark's plain reference: the 1M and the 2M + P3 column steps in
eager PyTorch, frozen here so that no later change to the program moves the
yardstick.

It imports nothing of the program: its parameter sets are worked out from
the same published defaults by its own copies of the parameter modules.
"""

from __future__ import annotations

from .column import (
    ColumnState,
    ColumnStateP3,
    step_column_1m,
    step_column_p3,
)

__all__ = ["ColumnState", "ColumnStateP3", "params_1m", "params_p3",
           "step_column_1m", "step_column_p3"]


def params_1m():
    """``(mp, tps, tv)``: the default 1M, thermodynamics and terminal
    velocity parameters."""
    from .parameters.m1 import microphysics_1m_params
    from .parameters.terminal_velocity import terminal_velocity_params
    from .parameters.thermodynamics import ThermodynamicsParameters

    return (microphysics_1m_params(), ThermodynamicsParameters(),
            terminal_velocity_params())


def params_p3(quadrature_order: int):
    """``(mp, tps)``: the default 2M warm rain with P3 ice at Gauss-Legendre
    ``quadrature_order``, and the thermodynamics parameters."""
    from .parameters.m2 import microphysics_2m_params
    from .parameters.thermodynamics import ThermodynamicsParameters

    return (microphysics_2m_params(with_ice=True,
                                   quadrature_order=quadrature_order),
            ThermodynamicsParameters())
