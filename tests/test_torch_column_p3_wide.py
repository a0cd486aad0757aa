"""The port's eager 2M + P3 column step against the JAX package's at
Gauss-Legendre 32 (K5b's nodes in two chunks on the card) and at 300
levels (K5c's level chunks). Float64, cold and warm-started, with
tests/test_torch_column_p3_scope.py's checks and tolerance. The 300-level
columns span 285 to 240 K over more states than the 8 x 6 ones, and in a
few of their 600 cells the fixed-trip Brent shape solve ends at another
iterate in the two packages (ROADMAP §3; on this seed 4 cells cold, up to
2.5e-3 apart in log lambda, and 4 warm): there, and at the level below,
which their sedimentation reaches, cells are set aside, at most MAX_ASIDE
of them a step; every other cell is held to rtol 1e-9. With both
packages' Brent run to more trips no cell is set aside
(tests/test_torch_column_p3_brent.py)."""

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

# cells of the 600 a 300-level step may set aside (1 %)
MAX_ASIDE = 6

CASES = {
    "GL-32": (dict(quadrature_order=32), dict(), 0),
    "GL-4_nlev300": (dict(quadrature_order=4), dict(ncol=2, nlev=300),
                     MAX_ASIDE),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_at_the_width(name):
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
