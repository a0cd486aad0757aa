"""The frozen reference against the program's plain steps, at small
shapes on the CPU: the same operations on the same float64 inputs give the
same bits."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import harness, inputs
from bench_h100 import reference as R

SEED = 2**33 + 17


@pytest.mark.parametrize("mode,nsub,dt", [("instantaneous", 1, 1.0),
                                          ("linearized_average", 1, 10.0),
                                          ("linearized_average", 2, 10.0)])
def test_1m_reference_equals_program_plain_step(mode, nsub, dt):
    from cloudmicrophysics_tpu_torch.models import column as C
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        terminal_velocity_params,
    )

    recipe = harness.load_cell("1m_inst")[2]["state"]
    packed = inputs.make_state(recipe, R.ColumnState._fields, 6, 16, SEED,
                               "cpu", torch.float64)
    fields = packed.unbind(0)
    program = C.step_column_1m(
        C.ColumnState(*fields), microphysics_1m_params(),
        ThermodynamicsParameters(), terminal_velocity_params(), dt, 250.0,
        mode=mode, nsub=nsub)
    ref = R.step_column_1m(R.ColumnState(*fields), *R.params_1m(), dt,
                           250.0, mode=mode, nsub=nsub)
    for name, a, b in zip(R.ColumnState._fields, program, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("warm", [False, True])
def test_p3_reference_equals_program_plain_step(order, warm):
    from cloudmicrophysics_tpu_torch.models import column as C
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_2m_params,
    )

    recipe = harness.load_cell("p3_gl16")[2]["state"]
    fields = inputs.make_state(recipe, R.ColumnStateP3._fields, 3, 12, SEED,
                               "cpu", torch.float64).unbind(0)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    tps = ThermodynamicsParameters()
    guess = None
    if warm:
        _, guess = C.step_column_p3(C.ColumnStateP3(*fields), mp, tps, 1.0,
                                    250.0)
    program, ll = C.step_column_p3(C.ColumnStateP3(*fields), mp, tps, 1.0,
                                   250.0, guess)
    ref, rll = R.step_column_p3(R.ColumnStateP3(*fields), *R.params_p3(order),
                                1.0, 250.0, guess)
    assert torch.equal(ll, rll)
    for name, a, b in zip(R.ColumnStateP3._fields, program, ref):
        assert torch.equal(a, b), name
