"""The port's eager 2M + P3 column step against the JAX package's at
Chebyshev-Gauss orders 5 and 25, orders where 32 does not divide 4N and N
is odd (K5b's ragged lane chunks on the card), beyond
tests/test_torch_column_p3.py's GL-4. Float64, cold and warm-started, with
tests/test_torch_column_p3_scope.py's checks and tolerance."""

import pytest
import torch

from cloudmicrophysics_tpu_torch.kernels import column_p3 as TK
from cloudmicrophysics_tpu_torch.utils.quadrature import (
    ChebyshevGauss,
    GaussLegendre,
)
from test_torch_column_p3 import _arrays  # noqa: E402
from test_torch_column_p3_scope import (  # noqa: E402
    check_both_starts,
    jax_two_steps,
    params_pair,
)

CASES = {
    "CG-5": (dict(quadrature_order=5), dict(), 0),
    "CG-25": (dict(quadrature_order=25), dict(), 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_at_the_order(name):
    options, shape, max_aside = CASES[name]
    mp_j, mp_t = params_pair(options)
    order = options["quadrature_order"]
    rule = GaussLegendre if order in (4, 32) else ChebyshevGauss
    assert mp_t.ice.quad.n == order
    assert torch.equal(torch.tensor(mp_t.ice.quad.nodes_weights()[0]).ravel(),
                       torch.tensor(rule(order).nodes_weights()[0]))
    a = _arrays(**shape)
    ll = check_both_starts(mp_t, a, jax_two_steps(mp_j, a), max_aside)
    assert TK.variant(mp_t, torch.float64).order == order
    assert bool(torch.isfinite(ll).any())
