"""The fused 1M, 2M and 2M + P3 column kernels on an NVIDIA GPU, against
their plain versions.

Needs a CUDA device (marker ``cuda``); without one every test skips. This
file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py -o addopts='' --noconftest -q

Tolerance: rtol 2e-5, atol 2e-9, the contract tests/test_kernels.py holds
the Pallas kernels to (for the P3 kernel: log lambda rtol 2e-5, fields
rtol 3e-5 / atol 1e-10, tests/test_kernels.py:192-198); tilings must agree
bit for bit (each cell is computed by the same code whatever block steps
it), and so must K5a's log lambda and the plain shape solve (the
fixed-trip Brent stops at another iterate on a last-bit change). The 1M
and 2M kernels (K1-K4) are held to their plain step bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu_torch.kernels import column1m as K
from cloudmicrophysics_tpu_torch.kernels import column2m as K2
from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
from cloudmicrophysics_tpu_torch.models.column import (
    Column1MStep,
    Column2MStep,
    ColumnP3Step,
    ColumnState,
    ColumnState2M,
    ColumnStateP3,
)
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters,
    microphysics_1m_params,
    microphysics_2m_params,
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
                                                  (512, 33, 64),
                                                  (96, 256, 32),
                                                  (64, 7, 3)])
def test_kernel_matches_plain(device, ncol, nlev, block_cols):
    # nlev 40, 33 and 7 leave the top 32-level chunk of a column ragged
    if ncol % block_cols:
        ncol += block_cols - ncol % block_cols
    st = _state(ncol, nlev, device)
    ref = K.step_column_1m_plain(st, MP, TPS, TV, DT, DZ)
    before = K.step_column_1m_fused.launches
    out = K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                                 block_cols=block_cols)
    assert K.step_column_1m_fused.launches == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    packed = K.step_column_1m_fused_packed(K.pack_state(st), MP, TPS, TV, DT,
                                           DZ, block_cols=block_cols)
    assert torch.equal(packed, K.pack_state(ref))


def test_column1m_step_module(device):
    model = Column1MStep(MP, TPS, TV, DT, DZ).to(device)
    # the kernel is built with the block's values: it stays on the host
    assert model.params.device.type == "cpu"
    st = _state(256, 64, device)
    packed = K.pack_state(st)
    for affine in (None, (1.001, 1e-9)):
        ref = K.step_column_1m_packed_plain(packed, MP, TPS, TV, DT, DZ,
                                            q_tot_affine=affine)
        assert torch.equal(model(packed, q_tot_affine=affine), ref)
    with pytest.raises(ValueError, match="host parameter block"):
        K.step_column_1m_fused_packed(packed, MP, TPS, TV, DT, DZ,
                                      block_cols=64,
                                      params=model.params.to(device))


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


def _state_2m(ncol, nlev, device, dtype=torch.float32, seed=7):
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    arrays = (np.linspace(1.2, 0.4, nlev)[None, :] * ones,
              np.linspace(300.0, 220.0, nlev)[None, :] * ones,
              1e-2 * rng.random(shape), 1e-3 * rng.random(shape),
              1e8 * rng.random(shape), 5e-4 * rng.random(shape),
              1e6 * rng.random(shape))
    return ColumnState2M(*(torch.as_tensor(a, dtype=dtype, device=device)
                           for a in arrays))


@pytest.mark.parametrize("is_limited", [True, False])
@pytest.mark.parametrize("rain_velocity", ["sb2006", "chen2022"])
@pytest.mark.parametrize("ncol,nlev,block_cols", [(512, 128, 64),
                                                  (1000, 40, 8),
                                                  (96, 256, 32),
                                                  (64, 512, 16)])
def test_2m_kernel_matches_plain(device, ncol, nlev, block_cols, is_limited,
                                 rain_velocity):
    # nlev 40 leaves the top 32-level chunk of a column ragged; 512 is
    # MAX_NLEV
    mp = microphysics_2m_params(is_limited=is_limited,
                                rain_velocity=rain_velocity)
    st = _state_2m(ncol, nlev, device)
    ref = K2.step_column_2m_plain(st, mp, TPS, DT, DZ)
    before = K2.step_column_2m_fused.launches
    out = K2.step_column_2m_fused(st, mp, TPS, DT, DZ, block_cols=block_cols)
    assert K2.step_column_2m_fused.launches == before + 1
    _assert_close(out, ref)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    packed = K2.step_column_2m_fused_packed(K2.pack_state_2m(st), mp, TPS,
                                            DT, DZ, block_cols=block_cols)
    assert torch.equal(packed, K2.pack_state_2m(out))


def test_column2m_step_module(device):
    mp = microphysics_2m_params()
    model = Column2MStep(mp, TPS, DT, DZ).to(device)
    # the kernel is built with the block's values: it stays on the host
    assert model.params.device.type == "cpu"
    st = _state_2m(256, 64, device)
    packed = K2.pack_state_2m(st)
    for affine in (None, (1.001, 1e-9)):
        ref = K2.step_column_2m_packed_plain(packed, mp, TPS, DT, DZ,
                                             q_tot_affine=affine)
        _assert_close(model(packed, q_tot_affine=affine), ref)
        assert torch.equal(model(packed, q_tot_affine=affine), ref)
    _assert_close(model(st), K2.step_column_2m_plain(st, mp, TPS, DT, DZ))
    with pytest.raises(ValueError, match="host parameter block"):
        K2.step_column_2m_fused_packed(packed, mp, TPS, DT, DZ, block_cols=64,
                                       params=model.params.to(device))


def test_2m_cuda_rejections(device):
    mp = microphysics_2m_params()
    st = _state_2m(64, 16, device)
    with pytest.raises(ValueError, match="not a multiple"):
        K2.step_column_2m_fused(st, mp, TPS, DT, DZ, block_cols=48)
    with pytest.raises(NotImplementedError, match="float32"):
        K2.step_column_2m_fused(_state_2m(64, 16, device, torch.float64), mp,
                                TPS, DT, DZ, block_cols=16)
    with pytest.raises(NotImplementedError, match="nlev"):
        K2.step_column_2m_fused(_state_2m(4, K2.MAX_NLEV + 1, device), mp,
                                TPS, DT, DZ, block_cols=4)
    with pytest.raises(ValueError, match="contiguous"):
        K2.step_column_2m_fused(
            st._replace(T=st.T.t().contiguous().t()), mp, TPS, DT, DZ,
            block_cols=16)


def _state_p3(ncol, nlev, device, dtype=torch.float32, seed=7):
    """Ice below freezing (unrimed to heavily rimed), cloud and rain where
    their freezing stays moderate, warm cells without ice."""
    rng = np.random.default_rng(seed)
    sh = (ncol, nlev)
    ones = np.ones((ncol, 1))
    T = np.linspace(285.0, 230.0, nlev)[None, :] * ones
    q_ice = np.where(T < 273.15, 10 ** rng.uniform(-6, -3, sh), 0.0)
    q_rim = q_ice * rng.uniform(0.0, 0.95, sh)
    q_lcl = np.where(T > 245.0, 1e-3 * rng.random(sh), 0.0)
    q_rai = np.where(T > 263.0, 5e-4 * rng.random(sh), 0.0)
    arrays = (np.linspace(1.2, 0.4, nlev)[None, :] * ones, T,
              q_lcl + q_rai + q_ice + 6e-3 * rng.random(sh), q_lcl,
              np.where(q_lcl > 0, 1e8 * rng.random(sh), 0.0), q_rai,
              np.where(q_rai > 0, 1e6 * rng.random(sh), 0.0), q_ice,
              np.where(q_ice > 0, q_ice / 10 ** rng.uniform(-11, -8, sh), 0),
              q_rim, q_rim / rng.uniform(100.0, 900.0, sh))
    return ColumnStateP3(*(torch.as_tensor(a, dtype=dtype, device=device)
                           for a in arrays))


def _assert_close_p3(out, ref):
    (st, ll), (st_ref, ll_ref) = out, ref
    assert torch.equal(torch.isinf(ll), torch.isinf(ll_ref))
    fin = torch.isfinite(ll_ref)
    torch.testing.assert_close(ll[fin], ll_ref[fin], rtol=2e-5, atol=0)
    for a, b in zip(st, st_ref):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=1e-10)


@pytest.mark.parametrize("order", K5.ORDERS)
@pytest.mark.parametrize("ncol,nlev,tilings", [(256, 64, (64, 32)),
                                               (250, 40, (10, 25))])
def test_p3_kernel_matches_plain(device, order, ncol, nlev, tilings):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    st = _state_p3(ncol, nlev, device)
    ref = K5.step_column_p3_plain(st, mp, TPS, DT, DZ)
    counted = (K5.step_column_p3_fused, K5.launch_solve, K5.launch_nodes,
               K5.launch_epilogue)
    before = [fn.launches for fn in counted]
    outs = [K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=bc)
            for bc in tilings]
    assert [fn.launches for fn in counted] == [n + len(tilings)
                                               for n in before]
    _assert_close_p3(outs[0], ref)
    for x, y in zip(outs[0][0] + (outs[0][1],), outs[1][0] + (outs[1][1],)):
        assert torch.equal(x, y)
    # warm start from the plain step's log lambda
    warm = K5.step_column_p3_fused(ref[0], mp, TPS, DT, DZ, ref[1],
                                   block_cols=tilings[0])
    _assert_close_p3(warm, K5.step_column_p3_plain(ref[0], mp, TPS, DT, DZ,
                                                   ref[1]))


def test_p3_kernel_options(device):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8,
                                is_limited=False, rain_velocity="chen2022")
    st = _state_p3(128, 32, device)
    _assert_close_p3(K5.step_column_p3_fused(st, mp, TPS, DT, DZ,
                                             block_cols=32),
                     K5.step_column_p3_plain(st, mp, TPS, DT, DZ))


def test_column_p3_step_module(device):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    model = ColumnP3Step(mp, TPS, DT, DZ).to(device)
    assert model.params.device == device
    st = _state_p3(256, 48, device)
    out = model(st)
    _assert_close_p3(out, K5.step_column_p3_plain(st, mp, TPS, DT, DZ))
    out2 = model(*out)
    _assert_close_p3(out2, K5.step_column_p3_plain(out[0], mp, TPS, DT, DZ,
                                                   out[1]))


def test_p3_cuda_rejections(device):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = _state_p3(64, 16, device)
    with pytest.raises(ValueError, match="not a multiple"):
        K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=48)
    with pytest.raises(NotImplementedError, match="float32"):
        K5.step_column_p3_fused(_state_p3(64, 16, device, torch.float64), mp,
                                TPS, DT, DZ, block_cols=16)
    with pytest.raises(NotImplementedError, match="nlev"):
        K5.step_column_p3_fused(_state_p3(4, K5.MAX_NLEV + 1, device), mp,
                                TPS, DT, DZ, block_cols=4)
    with pytest.raises(NotImplementedError, match="aspect_ratio"):
        K5.step_column_p3_fused(
            st, microphysics_2m_params(with_ice=True, quadrature_order=8,
                                       aspect_ratio="NoAspectRatio"),
            TPS, DT, DZ, block_cols=16)
    with pytest.raises(NotImplementedError, match="quadrature orders"):
        K5.step_column_p3_fused(
            st, microphysics_2m_params(with_ice=True, quadrature_order=32),
            TPS, DT, DZ, block_cols=16)
    with pytest.raises(ValueError, match="contiguous"):
        K5.step_column_p3_fused(st._replace(T=st.T.t().contiguous().t()),
                                mp, TPS, DT, DZ, block_cols=16)


def _ladder_state(device, nrep=8, nlev=16):
    """The 10 curated ladder states of the package's float64 record, each
    over ``nrep`` columns of ``nlev`` levels with a rho and T profile."""
    path = (Path(K5.__file__).resolve().parents[1] / "data"
            / "p3_ladder_gl16.json")
    rows = np.asarray(json.loads(path.read_text())["states"], np.float64)
    arr = np.repeat(rows[:, None, :], nrep, axis=1).reshape(-1, 11)
    arr = np.repeat(arr[:, None, :], nlev, axis=1)
    arr[..., 0] *= np.linspace(1.05, 0.95, nlev)[None, :]
    arr[..., 1] += np.linspace(2.0, -2.0, nlev)[None, :]
    return ColumnStateP3(*(torch.as_tensor(arr[..., i], dtype=torch.float32,
                                           device=device)
                           for i in range(11)))


@pytest.mark.parametrize("states", ["ladder", "mixed"])
def test_p3_solve_kernel_loglambda_is_bit_identical(device, states):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=16)
    st = _ladder_state(device) if states == "ladder" else _state_p3(
        256, 64, device)
    before = K5.launch_solve.launches
    ref = K5.loglambda_p3_plain(st, mp)
    assert torch.equal(K5.loglambda_p3_fused(st, mp, TPS), ref)
    assert K5.launch_solve.launches == before + 1
    # warm-started off the root, and at the root itself
    away = torch.where(torch.isfinite(ref), ref + 0.25, ref)
    for guess in (away, ref):
        assert torch.equal(K5.loglambda_p3_fused(st, mp, TPS, guess),
                           K5.loglambda_p3_plain(st, mp, guess))


def test_p3_step_is_bit_identical_on_the_ladder(device):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=16)
    st = _ladder_state(device)
    out, ll = K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=8)
    ref, ll_ref = K5.step_column_p3_plain(st, mp, TPS, DT, DZ)
    assert torch.equal(ll, ll_ref)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_entry_points_default_to_the_gpu(device):
    from cloudmicrophysics_tpu_torch.parameters import (
        column_state_p3_from_numpy,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    # K1-K4 are built with their parameter block's values: it stays on the
    # host; K5 reads its block from device memory
    assert Column1MStep(MP, TPS, TV, DT, DZ).params.device.type == "cpu"
    assert Column2MStep(microphysics_2m_params(), TPS, DT,
                        DZ).params.device.type == "cpu"
    assert ColumnP3Step(mp, TPS, DT, DZ).params.device.type == "cuda"
    arrays = {name: np.asarray(t.cpu()) for name, t in
              zip(ColumnStateP3._fields, _state_p3(64, 16, device))}
    st = column_state_p3_from_numpy(arrays)
    assert all(t.device.type == "cuda" for t in st)
    _assert_close_p3(ColumnP3Step(mp, TPS, DT, DZ)(st),
                     K5.step_column_p3_plain(st, mp, TPS, DT, DZ))


# ---------------------------------------------------------------------------
# The roofline's kernels (kernels/roof.py): K6 and the expf probe, bit for
# bit against their plain versions, and the perf harness on the card
# ---------------------------------------------------------------------------

def _roof_inputs(device):
    """(label, tensor, output or None): a packed state, a ragged one whose
    numel is 3 more than a multiple of 4, a view of it offset by one
    element with a fresh output (every element on the scalar path) and
    with an output offset alike (scalar head and tail around float4s), and
    K6c's all-ones input."""
    ragged = K.pack_state(_state(1001, 33, device))
    offset = ragged.reshape(-1)[1:]
    return [
        ("(7, 512, 128)", K.pack_state(_state(512, 128, device)), None),
        ("ragged (7, 1001, 33)", ragged, None),
        ("offset view, fresh output", offset, None),
        ("offset view, offset output", offset,
         torch.empty(offset.numel() + 1, device=device)[1:]),
        ("all ones", torch.ones(7, 512, 128, device=device), None),
    ]


def test_copy_kernel_is_bit_identical(device):
    from cloudmicrophysics_tpu_torch.kernels import roof as R

    for s in (R.scale_of(3), torch.tensor(1.0 + 1e-6 * 5)):
        for label, x, out in _roof_inputs(device):
            got = R.copy_step(x, s, out=out)
            assert out is None or got is out
            assert torch.equal(got, R.copy_step_plain(x, s)), label


def test_exp_chain_kernel_is_bit_identical(device):
    from cloudmicrophysics_tpu_torch.kernels import roof as R

    for i, (label, x, _) in enumerate(_roof_inputs(device)):
        for chain in (R.CHAIN, 3):
            assert torch.equal(R.exp_chain_step(x, i, chain),
                               R.exp_chain_plain(x, i, chain)), label


def test_roof_rejections(device):
    from cloudmicrophysics_tpu_torch.kernels import roof as R

    x = torch.ones(64, 16, device=device)
    for step in (R.copy_step, R.exp_chain_step):
        with pytest.raises(NotImplementedError, match="float32"):
            step(x.double(), 1.0)
        with pytest.raises(NotImplementedError, match="contiguous"):
            step(x.t(), 1.0)
    with pytest.raises(NotImplementedError, match="contiguous"):
        R.copy_step(x, 1.0, out=torch.empty(16, 64, device=device).t())
    with pytest.raises(ValueError, match="overlaps"):
        R.copy_step(x, 1.0, out=x)


def test_bench_press_builds_nothing_on_a_repeat_call(device):
    from cloudmicrophysics_tpu_torch.kernels import roof as R
    from cloudmicrophysics_tpu_torch.perf import bench_press

    model = Column1MStep(MP, TPS, TV, DT, DZ)
    packed = K.pack_state(_state(512, 64, device))
    r = bench_press(model, (packed,), 1e9, name="Column1MStep")
    assert r.n_traces == 1 and r.ok and r.best_ns > 0
    r = bench_press(lambda x: R.copy_step(x, 2.0), (packed,), 1e9)
    assert r.n_traces == 1
