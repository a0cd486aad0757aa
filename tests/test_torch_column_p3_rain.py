"""The port's eager 2M + P3 column step against the JAX package's with the
ice container's rain PSD unlimited (``mp.ice.rain_pdf.is_limited=False``,
a build of its own of K5 on the card) and with the warm rain's unlimited
PSD and Chen 2022 rain fall speeds (K5c's templates). Float64, cold and
warm-started, with tests/test_torch_column_p3_scope.py's checks and
tolerance."""

import pytest
import torch

from cloudmicrophysics_tpu_torch.kernels import column_p3 as TK
from test_torch_column_p3 import _arrays  # noqa: E402
from test_torch_column_p3_scope import (  # noqa: E402
    check_both_starts,
    jax_two_steps,
    params_pair,
)

CASES = {
    "unlimited_ice_rain_psd": dict(quadrature_order=4,
                                   ice_rain_limited=False),
    "warm_rain_unlimited_chen2022": dict(quadrature_order=4,
                                         is_limited=False,
                                         rain_velocity="chen2022"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_with_the_rain_psd(name):
    mp_j, mp_t = params_pair(CASES[name])
    a = _arrays()
    ll = check_both_starts(mp_t, a, jax_two_steps(mp_j, a))
    v = TK.variant(mp_t, torch.float64)
    assert v.ice_rain_limited == (name != "unlimited_ice_rain_psd")
    assert TK.warm_variant(mp_t) == ((0, 1) if name.startswith("warm")
                                     else (1, 0))
    assert torch.isfinite(ll[2:, 3:]).all()
