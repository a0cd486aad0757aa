"""The fused 1M column kernel on an NVIDIA GPU, against its plain version.

Needs a CUDA device (marker ``cuda``); without one every test skips. This
file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py -o addopts='' --noconftest -q

Tolerance: rtol 2e-5, atol 2e-9, the contract tests/test_kernels.py holds
the Pallas kernels to; tilings must agree bit for bit (each cell is
computed by the same code whatever block steps it).
"""

import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu_torch.kernels import column1m as K
from cloudmicrophysics_tpu_torch.models.column import Column1MStep, ColumnState
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters,
    microphysics_1m_params,
    terminal_velocity_params,
)

pytestmark = pytest.mark.cuda

MP = microphysics_1m_params()
TPS = ThermodynamicsParameters()
TV = terminal_velocity_params()
DT, DZ = 1.0, 100.0


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(ncol, nlev, device, dtype=torch.float32, seed=7):
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    arrays = (np.linspace(1.2, 0.4, nlev)[None, :] * ones,
              np.linspace(300.0, 230.0, nlev)[None, :] * ones,
              1e-2 * rng.random(shape), 1e-3 * rng.random(shape),
              5e-4 * rng.random(shape), 5e-4 * rng.random(shape),
              5e-4 * rng.random(shape))
    return ColumnState(*(torch.as_tensor(a, dtype=dtype, device=device)
                         for a in arrays))


def _assert_close(out, ref):
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-9)


@pytest.mark.parametrize("ncol,nlev,block_cols", [(512, 128, 64),
                                                  (1000, 40, 8),
                                                  (96, 256, 32)])
def test_kernel_matches_plain(device, ncol, nlev, block_cols):
    st = _state(ncol, nlev, device)
    ref = K.step_column_1m_plain(st, MP, TPS, TV, DT, DZ)
    before = K.step_column_1m_fused.launches
    out = K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                                 block_cols=block_cols)
    assert K.step_column_1m_fused.launches == before + 1
    _assert_close(out, ref)
    packed = K.step_column_1m_fused_packed(K.pack_state(st), MP, TPS, TV, DT,
                                           DZ, block_cols=block_cols)
    assert torch.equal(packed, K.pack_state(out))


def test_column1m_step_module(device):
    model = Column1MStep(MP, TPS, TV, DT, DZ).to(device)
    assert model.params.device == device
    st = _state(256, 64, device)
    packed = K.pack_state(st)
    for affine in (None, (1.001, 1e-9)):
        ref = K.step_column_1m_packed_plain(packed, MP, TPS, TV, DT, DZ,
                                            q_tot_affine=affine)
        _assert_close(model(packed, q_tot_affine=affine), ref)


def test_cuda_rejections(device):
    st = _state(64, 16, device)
    with pytest.raises(ValueError, match="not a multiple"):
        K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ, block_cols=48)
    with pytest.raises(NotImplementedError, match="instantaneous"):
        K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                               mode="linearized_average", block_cols=16)
    with pytest.raises(NotImplementedError, match="float32"):
        K.step_column_1m_fused(_state(64, 16, device, torch.float64), MP, TPS,
                               TV, DT, DZ, block_cols=16)
    with pytest.raises(ValueError, match="contiguous"):
        K.step_column_1m_fused(
            st._replace(T=st.T.t().contiguous().t()), MP, TPS, TV, DT, DZ,
            block_cols=16)
