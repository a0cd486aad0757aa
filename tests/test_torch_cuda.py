"""The fused 1M, 2M and 2M + P3 column kernels and the ARG2000 activation
kernels on an NVIDIA GPU, against their plain versions.

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
and 2M kernels (K1-K4) are held to their plain step bit for bit, also
with the shipped calibrated TOML parameter sets. The 0-D drivers, the
boosted-trees fit and the UKI calibration run on the card against
float64 or the CPU (tolerances at each test). K2, K3 and K5 stepped
column-sharded on a one-rank NCCL group are bit-identical to the
unsharded steps. The examples run on the card by default: the liquid-only
parcel within rtol 1e-6 of the JAX record
(``cloudmicrophysics_tpu_torch/data/examples_f64.json``), and the squall
through K5, bit for bit with the plain step. The ARG2000 number and mass
kernels are bit for bit the eager activation at float32 and float64 on
the cell ``arg_mam4``'s state, the emulator's draw, ``chip_smoke.py``'s
two-mode states, a ``ModeB`` mode and broadcast fields. The point-wise P3
tendencies are bit for bit the eager code at every K5 variant and at ice
layouts from none to every point, also where K5b skips warps without ice
and its scratch record holds NaN.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudmicrophysics_tpu_torch import trace
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
    step_column_p3,
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


def _launches(*wrappers):
    """The launch counter of each kernel wrapper, ``launches.<name>``."""
    return [trace.counter(f"launches.{fn.__name__}") for fn in wrappers]


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
    before = _launches(K.step_column_1m_fused)
    out = K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                                 block_cols=block_cols)
    assert _launches(K.step_column_1m_fused) == [n + 1 for n in before]
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
    with pytest.raises(ValueError, match="unknown tendency mode"):
        K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                               mode="instantaneous_verbose", block_cols=16)
    with pytest.raises(ValueError, match="nsub"):
        K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ,
                               mode="linearized_average", nsub=0,
                               block_cols=16)
    # instantaneous ignores nsub, as the eager step does
    ref = K.step_column_1m_plain(st, MP, TPS, TV, DT, DZ)
    for a, b in zip(K.step_column_1m_fused(st, MP, TPS, TV, DT, DZ, nsub=0,
                                           block_cols=16), ref):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        K.step_column_1m_fused(_state(64, 16, device, torch.bfloat16), MP,
                               TPS, TV, DT, DZ, block_cols=16)
    with pytest.raises(ValueError, match="contiguous"):
        K.step_column_1m_fused(
            st._replace(T=st.T.t().contiguous().t()), MP, TPS, TV, DT, DZ,
            block_cols=16)


# the whole scope of step_column_1m on the card, bit for bit against the
# plain step: linearized_average, each non-default option set, float64,
# 512 levels and a level count that is not a multiple of 32
SCOPE_OPTIONS = [
    {"cloud_ice_formation": "TemperatureDependent"},
    {"rain_autoconversion": "PrescribedNd"},
    {"snow_autoconversion": "WithSupersaturation"},
    {"snow_deposition_sublimation": "SublimationOnly"},
    {slot: None for slot in K.OPTION_CODES},
    {"cloud_ice_formation": "TemperatureDependent",
     "rain_autoconversion": "PrescribedNd",
     "snow_autoconversion": "WithSupersaturation",
     "snow_deposition_sublimation": "SublimationOnly",
     "cloud_ice_melt": None, "rain_snow_accretion": None},
] + [{slot: None} for slot in K.OPTION_CODES]


def _assert_1m_bits(st, mp, block_cols, dt=DT, **kw):
    ref = K.step_column_1m_plain(st, mp, TPS, TV, dt, DZ, **kw)
    out = K.step_column_1m_fused(st, mp, TPS, TV, dt, DZ,
                                 block_cols=block_cols, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    packed = K.step_column_1m_fused_packed(K.pack_state(st), mp, TPS, TV, dt,
                                           DZ, block_cols=block_cols, **kw)
    assert torch.equal(packed, K.pack_state(ref))


@pytest.mark.parametrize("nsub", [1, 2, 4])
@pytest.mark.parametrize("sediment_cloud", [True, False])
def test_linearized_kernel_matches_plain(device, nsub, sediment_cloud):
    _assert_1m_bits(_state(512, 37, device), MP, 64, dt=10.0,
                    mode="linearized_average", nsub=nsub,
                    sediment_cloud=sediment_cloud)


@pytest.mark.parametrize("opts", SCOPE_OPTIONS)
def test_option_kernels_match_plain(device, opts):
    _assert_1m_bits(_state(512, 64, device), microphysics_1m_params(**opts),
                    64)


@pytest.mark.parametrize("mode", ["instantaneous", "linearized_average"])
@pytest.mark.parametrize("nlev", [64, 37, 512, 333])
def test_float64_and_levels_1m_match_plain(device, mode, nlev):
    for dtype in (torch.float32, torch.float64):
        _assert_1m_bits(_state(128, nlev, device, dtype), MP, 32, dt=10.0,
                        mode=mode, nsub=2)


def test_column1m_step_module_scope(device):
    # Column1MStep takes mode, nsub and sediment_cloud, and steps a float64
    # state with its float64 block
    model = Column1MStep(MP, TPS, TV, 10.0, DZ, mode="linearized_average",
                         nsub=4, sediment_cloud=False)
    for dtype in (torch.float32, torch.float64):
        st = _state(256, 64, device, dtype)
        ref = K.step_column_1m_plain(st, MP, TPS, TV, 10.0, DZ,
                                     mode="linearized_average", nsub=4,
                                     sediment_cloud=False)
        for a, b in zip(model(st), ref):
            assert torch.equal(a, b)
    assert model.params.dtype == torch.float32


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
                                                  (64, 512, 16),
                                                  (256, 100, 128),
                                                  (96, 7, 32),
                                                  (64, 1, 16),
                                                  (48, 33, 24)])
def test_2m_kernel_matches_plain(device, ncol, nlev, block_cols, is_limited,
                                 rain_velocity):
    # a warp steps its columns' cells in 32-cell windows: (1000, 40, 8) a
    # column a warp and a partial window at its foot; (256, 100, 128) the
    # 2m_fields cell's 8 columns of 100 levels a warp, windows across
    # columns; (96, 7, 32) and (64, 1, 16) windows over several columns;
    # (48, 33, 24) warps of two columns and of one
    mp = microphysics_2m_params(is_limited=is_limited,
                                rain_velocity=rain_velocity)
    st = _state_2m(ncol, nlev, device)
    ref = K2.step_column_2m_plain(st, mp, TPS, DT, DZ)
    before = _launches(K2.step_column_2m_fused)
    out = K2.step_column_2m_fused(st, mp, TPS, DT, DZ, block_cols=block_cols)
    assert _launches(K2.step_column_2m_fused) == [n + 1 for n in before]
    _assert_close(out, ref)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    packed = K2.step_column_2m_fused_packed(K2.pack_state_2m(st), mp, TPS,
                                            DT, DZ, block_cols=block_cols)
    assert torch.equal(packed, K2.pack_state_2m(out))


@pytest.mark.parametrize("is_limited", [True, False])
@pytest.mark.parametrize("rain_velocity", ["sb2006", "chen2022"])
@pytest.mark.parametrize("ncol,nlev,block_cols", [(512, 64, 64),
                                                  (256, 333, 16),
                                                  (64, 1024, 16),
                                                  (256, 100, 128)])
def test_2m_float64_kernel_matches_plain(device, ncol, nlev, block_cols,
                                         is_limited, rain_velocity):
    mp = microphysics_2m_params(is_limited=is_limited,
                                rain_velocity=rain_velocity)
    st = _state_2m(ncol, nlev, device, torch.float64)
    ref = K2.step_column_2m_plain(st, mp, TPS, DT, DZ)
    out = K2.step_column_2m_fused(st, mp, TPS, DT, DZ, block_cols=block_cols)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    packed = K2.step_column_2m_fused_packed(K2.pack_state_2m(st), mp, TPS,
                                            DT, DZ, block_cols=block_cols)
    assert torch.equal(packed, K2.pack_state_2m(ref))
    model = Column2MStep(mp, TPS, DT, DZ)
    assert torch.equal(model(K2.pack_state_2m(st)), packed)


@pytest.mark.parametrize("dtype,warps", [(torch.float32, 16),
                                         (torch.float64, 8)])
@pytest.mark.parametrize("ncol,nlev,block_cols", [(256, 100, 128),
                                                  (48, 33, 24),
                                                  (96, 7, 32),
                                                  (64, 1, 16)])
def test_k3_lane_counters_follow_the_launch_plan(device, dtype, warps, ncol,
                                                 nlev, block_cols):
    """One K4 launch and one K3 launch each add to ``k3.lane_slots`` the
    lane slots of their window plan (:func:`K2.lane_slots` at the build's
    warps) and to ``k3.cells`` their cells, and at float32 the windows the
    device steps, counted by the probe build (float32 only, as its stage
    sinks), are those slots over 32: at the cell's 100 levels and 128
    columns a block every lane is busy."""
    mp = microphysics_2m_params()
    st = _state_2m(ncol, nlev, device, dtype)
    lib = K2._prepare(mp, TPS, nlev, dtype, None)
    assert lib.column2m_threads_per_block() == 32 * warps
    slots = K2.lane_slots(ncol, nlev, block_cols, warps)
    names = ("k3.lane_slots", "k3.cells")
    for step in (lambda: K2.step_column_2m_fused(st, mp, TPS, DT, DZ,
                                                 block_cols=block_cols),
                 lambda: K2.step_column_2m_fused_packed(
                     K2.pack_state_2m(st), mp, TPS, DT, DZ,
                     block_cols=block_cols)):
        before = [trace.counter(n) for n in names]
        step()
        assert [trace.counter(n) - b for n, b in zip(names, before)] == [
            slots, ncol * nlev]
    if dtype == torch.float32:
        probe = K2._library(K2.host_params(None, mp, TPS, dtype),
                            K2.warm_variant(mp), "probe")
        sums = torch.zeros(len(K2.PROBE_STAGES) + 1, dtype=torch.int64,
                           device=device)
        assert probe.column2m_probe_set(sums.data_ptr(), device.index) == 0
        K2.launch_packed(probe, K2.pack_state_2m(st), DT, DZ, block_cols)
        torch.cuda.synchronize()
        assert 32 * sums[-1].item() == slots
    if nlev == 100:
        assert slots == ncol * nlev


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
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        K2.step_column_2m_fused(_state_2m(64, 16, device, torch.bfloat16), mp,
                                TPS, DT, DZ, block_cols=16)
    # K5 refuses what the JAX step cannot run either: another dtype
    mp3 = microphysics_2m_params(with_ice=True, quadrature_order=8)
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        K5.step_column_p3_fused(_state_p3(64, 16, device, torch.bfloat16),
                                mp3, TPS, DT, DZ, block_cols=16)
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


# the quadrature orders K5 is held to: every Gauss-Legendre order of
# build_quadrature, Chebyshev-Gauss 5 and 25 (32 does not divide 4N, N odd)
# and the reference default CG-100
P3_ORDERS = (4, 8, 16, 32, 40, 64, 5, 25, 100)


@pytest.mark.parametrize("order", P3_ORDERS)
@pytest.mark.parametrize("ncol,nlev,tilings", [(256, 64, (64, 32)),
                                               (250, 40, (10, 25))])
def test_p3_kernel_matches_plain(device, order, ncol, nlev, tilings):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    st = _state_p3(ncol, nlev, device)
    ref = K5.step_column_p3_plain(st, mp, TPS, DT, DZ)
    counted = (K5.step_column_p3_fused, K5.launch_solve, K5.launch_nodes,
               K5.launch_epilogue)
    before = _launches(*counted)
    outs = [K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=bc)
            for bc in tilings]
    assert _launches(*counted) == [n + len(tilings) for n in before]
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


def _p3_scope(order=16, ice_rain_limited=True, **kw):
    import dataclasses

    mp = microphysics_2m_params(with_ice=True, quadrature_order=order, **kw)
    if ice_rain_limited:
        return mp
    return dataclasses.replace(mp, ice=dataclasses.replace(
        mp.ice, rain_pdf=dataclasses.replace(mp.ice.rain_pdf,
                                             is_limited=False)))


def _assert_same_p3(out, ref):
    (st, ll), (st_ref, ll_ref) = out, ref
    assert torch.equal(ll, ll_ref)
    for name, a, b in zip(st._fields, st, st_ref):
        assert torch.equal(a, b), name


# K5's scope beyond the defaults: each a build of its own, bit for bit
# against its plain step, cold and warm-started, through two tilings
P3_SCOPE = {
    "SlopeConstant": (dict(slope_law="constant"), torch.float32, 256, 32),
    "NoAspectRatio": (dict(aspect_ratio="NoAspectRatio"), torch.float32,
                      256, 32),
    "unlimited ice rain PSD": (dict(ice_rain_limited=False), torch.float32,
                               256, 32),
    "float64 GL-16": (dict(), torch.float64, 256, 32),
    "float64 CG-5": (dict(order=5), torch.float64, 128, 32),
    "float64 options": (dict(slope_law="constant",
                             aspect_ratio="NoAspectRatio",
                             ice_rain_limited=False, is_limited=False,
                             rain_velocity="chen2022"), torch.float64, 64, 16),
    "nlev 300": (dict(), torch.float32, 8, 300),
    "nlev 512 float64": (dict(order=8), torch.float64, 4, 512),
    "CG-100 float64": (dict(order=100), torch.float64, 16, 16),
    # 80 liquid nodes: K5b holds their factors 64 at a time
    "CG-160": (dict(order=160), torch.float32, 16, 16),
    # 4 lanes a cell, 32 cells a block
    "CG-1": (dict(order=1), torch.float32, 64, 16),
    # the last node chunk in fewer lane passes than the others: GL-40's
    # 160 nodes in 2 + 2 + 1, CG-24's 96 in 2 + 1
    "GL-40": (dict(order=40), torch.float32, 64, 16),
    "CG-24": (dict(order=24), torch.float32, 64, 16),
}


@pytest.mark.parametrize("name", list(P3_SCOPE))
def test_p3_kernel_scope_is_bit_identical(device, name):
    opts, dtype, ncol, nlev = P3_SCOPE[name]
    mp = _p3_scope(**opts)
    st = _state_p3(ncol, nlev, device, dtype)
    ref = K5.step_column_p3_plain(st, mp, TPS, DT, DZ)
    counted = (K5.step_column_p3_fused, K5.launch_solve, K5.launch_nodes,
               K5.launch_epilogue)
    before = _launches(*counted)
    tilings = (ncol, ncol // 2 if ncol % 2 == 0 else 1)
    outs = [K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=bc)
            for bc in tilings]
    assert _launches(*counted) == [n + 2 for n in before]
    for out in outs:
        _assert_same_p3(out, ref)
    warm = K5.step_column_p3_fused(ref[0], mp, TPS, DT, DZ, ref[1],
                                   block_cols=tilings[0])
    _assert_same_p3(warm, K5.step_column_p3_plain(ref[0], mp, TPS, DT, DZ,
                                                  ref[1]))
    assert warm[0].rho.dtype == dtype


@pytest.mark.parametrize("order,ratio", [(16, 1.0), (40, 1.0),
                                         (100, 416 / 400)])
def test_k5b_node_counters_follow_the_launch_plan(device, order, ratio):
    """One fused step adds to ``k5b.node_evals`` the lane-node evaluations
    of its launch plan (cells x lanes x passes) and to ``k5b.nodes`` the
    ice nodes it sums (cells x 4N): every evaluation is summed but the
    masked lanes of a last pass that is partly live (CG-100's 16)."""
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    ncol, nlev = 32, 8
    st = _state_p3(ncol, nlev, device)
    plan = K5.launch_plan(ncol, nlev, order, ncol)
    before = [trace.counter(n) for n in ("k5b.node_evals", "k5b.nodes")]
    K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=ncol)
    evals, nodes = (trace.counter(n) - b for n, b in
                    zip(("k5b.node_evals", "k5b.nodes"), before))
    cells = ncol * nlev
    assert evals == cells * plan.lanes_per_cell * plan.node_passes
    assert nodes == cells * 4 * order
    assert evals / nodes == ratio


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
    # a float64 state steps with a float64 buffer on the module's device
    st64 = _state_p3(64, 48, device, torch.float64)
    out64 = model(st64)
    assert model.block(torch.float64).device == device
    _assert_same_p3(out64, K5.step_column_p3_plain(st64, mp, TPS, DT, DZ))


def test_p3_cuda_rejections(device):
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = _state_p3(64, 16, device)
    with pytest.raises(ValueError, match="not a multiple"):
        K5.step_column_p3_fused(st, mp, TPS, DT, DZ, block_cols=48)
    # only what the JAX step cannot run either: another dtype, ice
    # nucleation other than Frostenberg2023, no P3 ice
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        K5.step_column_p3_fused(_state_p3(64, 16, device, torch.float16), mp,
                                TPS, DT, DZ, block_cols=16)
    from cloudmicrophysics_tpu_torch.parameters import Mohler2006

    with pytest.raises(NotImplementedError, match="Frostenberg2023"):
        K5.step_column_p3_fused(
            st, microphysics_2m_params(with_ice=True, quadrature_order=8,
                                       ice_nucleation=Mohler2006()),
            TPS, DT, DZ, block_cols=16)
    with pytest.raises(NotImplementedError, match="mp.ice"):
        K5.step_column_p3_fused(st, microphysics_2m_params(), TPS, DT, DZ,
                                block_cols=16)
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
    before = _launches(K5.launch_solve)
    ref = K5.loglambda_p3_plain(st, mp)
    assert torch.equal(K5.loglambda_p3_fused(st, mp, TPS), ref)
    assert _launches(K5.launch_solve) == [n + 1 for n in before]
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


# ---------------------------------------------------------------------------
# The 0-D drivers on the card: an ensemble member against its single run
# (bit for bit: broadcasting must not change a member's arithmetic), and
# float32 against float64
# ---------------------------------------------------------------------------

def _aeroact_ensemble(device, n=256, seed=0):
    """An emulator-style AeroAct ensemble (models/emulator.py:306-344):
    the state and its per-member parameters, float32 on ``device``."""
    from cloudmicrophysics_tpu_torch.models import parcel as PM
    from cloudmicrophysics_tpu_torch.ops import thermo as TDI
    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Sulfate

    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    member = dict(r_nuc=f32(10 ** rng.uniform(-8.2, -6.8, n)),
                  aero_sigma_g=f32(rng.uniform(1.4, 2.4, n)),
                  N_aer_act=f32(10 ** rng.uniform(6.5, 9.0, n)),
                  kappa=f32(rng.uniform(0.1, 1.2, n)),
                  w=f32(10 ** rng.uniform(-1.0, 0.7, n)))
    T, p = f32(rng.uniform(270.0, 300.0, n)), f32(rng.uniform(7e4, 1.02e5, n))
    z = torch.zeros_like(T)
    rho = TDI.air_density(TPS, T, p, z, z, z)
    q_vap = TDI.p2q(TPS, T, rho,
                    TDI.saturation_vapor_pressure_over_liquid(TPS, T))
    ic = PM.ParcelState(S_l=torch.full_like(T, 1.0001), p_air=p, T=T,
                        q_vap=q_vap, q_liq=z, q_ice=z,
                        N_aer=member["N_aer_act"], N_liq=z, N_ice=z,
                        ln_inpc=z)
    base = PM.parcel_params(aerosol_act="AeroAct", aerosol=Sulfate(),
                            condensation_growth="Condensation", const_dt=0.2)
    return ic, base, member


def _with_members(base, member, sl):
    import dataclasses

    m = {k: v[sl] for k, v in member.items()}
    kappa = m.pop("kappa")
    return dataclasses.replace(base, **m, aerosol=dataclasses.replace(
        base.aerosol, kappa=kappa))


def test_parcel_member_is_bit_identical_to_its_single_run(device):
    from cloudmicrophysics_tpu_torch.models import parcel as PM

    ic, base, member = _aeroact_ensemble(device)
    whole = PM.run_parcel(ic, 0.0, 10.0, _with_members(base, member,
                                                       slice(None)))
    for i in (0, 7, 255):
        sl = slice(i, i + 1)
        one = PM.run_parcel(PM.ParcelState(*(v[sl].clone() for v in ic)),
                            0.0, 10.0, _with_members(base, member, sl))
        for name, a, b in zip(PM.ParcelState._fields, whole, one):
            assert torch.equal(a[:, sl], b), (i, name)
    assert all(bool(torch.isfinite(v).all()) for v in whole)


def test_parcel_float32_agrees_with_float64_on_the_card(device):
    """The TPU benchmark's parcel (benchmarks/bench_suite.py:229-242), 300
    steps: float32 within rtol 1e-4 of float64 (float32 Euler rounding of
    T and p accumulates to ~3e-5 relative over 1000 steps on the CPU)."""
    from cloudmicrophysics_tpu_torch.models import parcel as PM

    params = PM.parcel_params(condensation_growth="Condensation",
                              const_dt=0.1, w=1.0)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        f = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        ic = PM.ParcelState(f(1.02), f(8e4), f(278.0), f(6e-3), f(1e-3),
                            f(0.0), f(1e8), f(1e8), f(0.0), f(0.0))
        runs[dtype] = PM.run_parcel(ic, 0.0, 30.0, params)
    for a, b in zip(runs[torch.float32], runs[torch.float64]):
        torch.testing.assert_close(a.double(), b, rtol=1e-4,
                                   atol=1e-12 * float(b.abs().max()))


def test_box_and_sandbox_float32_against_float64(device):
    """The Alpert-Knopf box (frozen fraction within 2e-3: float32 rounding
    of T accumulates over the steps) and the P3 sandbox, float32 through
    (rtol 1e-6, about eight float32 ulps: a few roundings in the
    thresholds)."""
    from cloudmicrophysics_tpu_torch.models import box as BOX
    from cloudmicrophysics_tpu_torch.models import p3_sandbox as SB
    from cloudmicrophysics_tpu_torch.parameters import parameters_p3
    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Illite

    frozen, sand = {}, {}
    N_l, r_l = 500e3, 1e-6
    q_l = N_l * 4 / 3 * np.pi * r_l**3 * 1000.0 / 1.2
    for dtype in (torch.float32, torch.float64):
        f = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        traj = BOX.run_box(BOX.BoxState(f(256.0), f(1e-6), f(1000.0),
                                        f(0.0)), 0.0, 1000.0, TPS, Illite(),
                           0.5 / 60, 1e-9, 10.0)
        frozen[dtype] = traj.N_ice / 1000.0
        sand[dtype] = SB.run_p3_sandbox(
            SB.P3SandboxState(f(100e6), f(1e-3), f(1e-4), f(1e-4 / 200)),
            0.0, 2.0, 1.0, parameters_p3(), TPS, Illite(), T=f(251.0),
            p_air=f(800e2), q_vap=f(8.1e-4), q_liq=f(q_l), N_liq=f(N_l),
            r_liq=f(r_l))
    torch.testing.assert_close(frozen[torch.float32].double(),
                               frozen[torch.float64], rtol=0, atol=2e-3)
    (t32, th32), (t64, th64) = sand[torch.float32], sand[torch.float64]
    assert all(v.dtype == torch.float32 for v in (*t32, *th32))
    torch.testing.assert_close(t32.N_ice.double(), t64.N_ice, rtol=1e-6,
                               atol=0)
    for a, b in zip(th32, th64):
        torch.testing.assert_close(a.double(), b, rtol=1e-6, atol=0)


def _emulator_data(device, n=2048):
    from cloudmicrophysics_tpu_torch.models import emulator as EM
    from cloudmicrophysics_tpu_torch.parameters import AirProperties
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolActivationParameters,
    )

    return EM.generate_training_data(AerosolActivationParameters(),
                                     AirProperties(), TPS, n_samples=n,
                                     seed=1, device=device)


def test_trees_fit_is_deterministic_on_the_card(device):
    """Two fits on the card are equal (a one-hot product per level, no
    atomics). Against the CPU fit a split may differ only where two
    candidates' float64 scores tie to rounding, after which every later
    tree differs too; the first tree, fitted to the same residuals on
    both, has the same splits."""
    from cloudmicrophysics_tpu_torch.models import emulator as EM

    X, y = _emulator_data(device)
    fits = [EM.train_emulator_trees(X, y, n_trees=50, depth=5,
                                    device=device)[1] for _ in range(2)]
    assert all(torch.equal(fits[0][k], fits[1][k]) for k in fits[0])
    cpu = EM.train_emulator_trees(X, y, n_trees=50, depth=5, device="cpu")[1]
    assert torch.equal(fits[0]["features"][0].cpu(), cpu["features"][0])
    assert torch.equal(fits[0]["thresholds"][0].cpu(), cpu["thresholds"][0])


def test_uki_on_the_card_agrees_with_the_cpu(device):
    """calibrate_abifm's UKI route over a 40 s chamber parcel, float64:
    theta within rtol 1e-6 of the CPU run (the card's transcendentals
    round apart from the CPU's by ~1e-16)."""
    from cloudmicrophysics_tpu_torch.models import calibration as CAL
    from cloudmicrophysics_tpu_torch.models import parcel as PM

    ic = PM.ParcelState(S_l=1.0, p_air=8e4, T=251.0, q_vap=7.3e-4,
                        q_liq=3.6e-6, q_ice=0.0, N_aer=0.0, N_liq=1e8,
                        N_ice=0.0, ln_inpc=0.0)
    kwargs = dict(heterogeneous="ABIFM", condensation_growth="Condensation",
                  const_dt=1.0, w=0.5)
    y_obs = [0.0, 0.01, 0.05, 0.15, 0.3]
    kw = dict(noise_std=0.02, prior_mean=(50.0, -9.0), prior_std=(8.0, 2.0),
              n_iterations=3, method="UKI")
    card = CAL.calibrate_abifm(ic, 40.0, kwargs, y_obs, device=device, **kw)
    host = CAL.calibrate_abifm(ic, 40.0, kwargs, y_obs, device="cpu", **kw)
    assert card.theta.device.type == "cuda"
    torch.testing.assert_close(card.theta.cpu(), host.theta, rtol=1e-6,
                               atol=0)


def test_calibrated_toml_blocks_through_k1_and_k3(device):
    """The shipped CliMA_1M and SB2006_limiters sets, loaded through the
    override pipeline, each build their own K1 or K3 library, bit for bit
    with the plain step."""
    from cloudmicrophysics_tpu_torch.parameters import (
        calibrated_overrides,
        microphysics_1m_params_from_overrides,
        microphysics_2m_params_from_overrides,
    )

    mp1 = microphysics_1m_params_from_overrides(
        calibrated_overrides("CliMA_1M"))
    model = Column1MStep(mp1, TPS, TV, DT, DZ, device=device)
    assert not torch.equal(model.params, Column1MStep(
        MP, TPS, TV, DT, DZ, device=device).params)
    packed = K.pack_state(_state(512, 128, device))
    assert torch.equal(model(packed), K.step_column_1m_packed_plain(
        packed, mp1, TPS, TV, DT, DZ))
    mp2 = microphysics_2m_params_from_overrides(
        calibrated_overrides("SB2006_limiters"))
    model2 = Column2MStep(mp2, TPS, DT, DZ, device=device)
    packed2 = K2.pack_state_2m(_state_2m(512, 128, device))
    assert torch.equal(model2(packed2), K2.step_column_2m_packed_plain(
        packed2, mp2, TPS, DT, DZ))


@pytest.fixture
def one_rank_mesh(device):
    """A one-rank NCCL group and its ``columns`` mesh on the card,
    destroyed after the test."""
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import column_mesh

    mesh = column_mesh()
    yield mesh
    dist.destroy_process_group()


def _sharded_paths(device):
    """(kernel counter, step, input) of K2, K4 and K5 (GL-8, cold then
    warm-started) through the column entry points."""
    from cloudmicrophysics_tpu_torch.models.column import step_column_2m

    m1 = Column1MStep(MP, TPS, TV, DT, DZ, device=device)
    mp2 = microphysics_2m_params()
    m3 = ColumnP3Step(microphysics_2m_params(with_ice=True,
                                             quadrature_order=8),
                      TPS, DT, DZ, device=device)
    return {
        "K2": (K.step_column_1m_fused, m1, _state(1024, 128, device)),
        "K4": (K2.step_column_2m_fused,
               lambda s: step_column_2m(s, mp2, TPS, DT, DZ, impl="fused"),
               _state_2m(1024, 128, device)),
        "K5": (K5.step_column_p3_fused, lambda s: m3(*m3(s)),
               _state_p3(256, 64, device)),
    }


@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_world1_sharded_kernels_are_bit_identical(device, one_rank_mesh,
                                                  kernel):
    from cloudmicrophysics_tpu_torch.parallel import is_dtensor, shard_columns
    from cloudmicrophysics_tpu_torch.perf import _leaves

    counter, step, st = _sharded_paths(device)[kernel]
    ref = list(_leaves(step(st)))
    sharded = shard_columns(st, one_rank_mesh)
    before = _launches(counter)
    out = list(_leaves(step(sharded)))
    assert _launches(counter)[0] >= before[0] + 1
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert is_dtensor(a) and a.to_local().device == device
        assert torch.equal(a.to_local(), b)
    with pytest.raises(ValueError, match="DTensor"):
        K.step_column_1m_fused(shard_columns(_state(64, 16, device),
                                             one_rank_mesh),
                               MP, TPS, TV, DT, DZ, block_cols=16)


def test_examples_run_on_the_card_by_default(device):
    from cloudmicrophysics_tpu_torch.examples import column_squall_p3 as SQ
    from cloudmicrophysics_tpu_torch.examples import parcel_liquid_only

    record = json.loads((Path(__file__).resolve().parent.parent
                         / "cloudmicrophysics_tpu_torch" / "data"
                         / "examples_f64.json").read_text())
    out = parcel_liquid_only.run()
    want = record["full"]["parcel_liquid_only"]
    for dsd in parcel_liquid_only.DSDS:
        for k in ("S_l", "T", "q_liq", "N_liq", "peak_S"):
            np.testing.assert_allclose(out[dsd][k], want[dsd][k], rtol=1e-6,
                                       atol=1e-12, err_msg=f"{dsd} {k}")
    assert out["rogers_max_err"] < 0.1
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    step = SQ.stepper(mp, 2.0, 250.0, device)
    assert isinstance(step, ColumnP3Step)
    with pytest.raises(ValueError, match="col_chunks"):
        SQ.stepper(mp, 2.0, 250.0, device, col_chunks=2)
    before = _launches(K5.step_column_p3_fused)
    state = SQ.column_state(8, 64, 250.0, device)
    got, ll_got, _ = SQ.rollout(state, step, 6, 250.0)
    assert _launches(K5.step_column_p3_fused) == [n + 6 for n in before]
    want, ll_want = state, None
    for _ in range(6):
        want, ll_want = step_column_p3(want, mp, TPS, 2.0, 250.0, ll_want)
    assert torch.equal(ll_got, ll_want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _profiled(fn, steps):
    """``fn`` called ``steps`` times under a CPU and CUDA profiler, after
    one call outside it; returns the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return prof


def test_launch_spans_hold_their_launches_on_the_profiler_clock(device):
    """Under the profiler, each of K1's and K5's launches lies in its span
    (``launch.k1``, ``launch.k5a/b/c``) inside ``column.prepare``'s step
    span, on one clock: the runtime's launch call inside the span; and the
    kernels the device ran a step (the benchmark's ``host.launches``) are
    those the launch counters counted."""
    m1 = Column1MStep(MP, TPS, TV, DT, DZ, device=device)
    packed = K.pack_state(_state(256, 64, device))
    m5 = ColumnP3Step(microphysics_2m_params(with_ice=True,
                                             quadrature_order=8),
                      TPS, DT, DZ, device=device)
    st = _state_p3(256, 64, device)
    cases = [(lambda: m1(packed), "step.column1m", ("launch.k1",),
              (K.step_column_1m_fused_packed,)),
             (lambda: m5(st), "step.column_p3",
              ("launch.k5a", "launch.k5b", "launch.k5c"),
              (K5.launch_solve, K5.launch_nodes, K5.launch_epilogue))]
    steps = 3
    for fn, step_name, spans, wrappers in cases:
        before = _launches(*wrappers)
        trace.reset()
        prof = _profiled(fn, steps)
        counted = [a - b - 1 for a, b in zip(_launches(*wrappers), before)]
        assert counted == [steps] * len(wrappers)
        totals = trace.totals()
        assert totals[step_name]["count"] == steps
        assert totals["column.prepare"]["count"] == steps
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e for e in events if e.device_type == cuda
                   and not e.name.startswith(("Memcpy", "Memset"))]
        assert len(kernels) == steps * len(spans)
        runtime = [e.time_range for e in events
                   if e.name.startswith(("cudaLaunchKernel",
                                         "cuLaunchKernel"))]
        for name in spans:
            assert totals[name]["count"] == steps
            ranges = [e.time_range for e in events if e.name == name]
            assert len(ranges) == steps
            for r in ranges:
                inside = [x for x in runtime
                          if r.start <= x.start and x.end <= r.end]
                assert len(inside) == 1, (name, len(inside))
    trace.reset()


def test_2m_spans_hold_their_launches_on_the_profiler_clock(device):
    """Under the profiler, K3's and K4's launches lie in their spans
    (``launch.k3``, ``launch.k4``) inside ``column.prepare``'s step span
    ``step.column2m``, on one clock; the fields path of
    ``step_column_2m(impl="fused")`` is K4 alone, one kernel a step, with
    no packing; the spans change no bit."""
    from cloudmicrophysics_tpu_torch.models.column import step_column_2m

    mp = microphysics_2m_params()
    model = Column2MStep(mp, TPS, DT, DZ, device=device)
    st = _state_2m(256, 64, device)
    packed = K2.pack_state_2m(st)
    ref = K2.step_column_2m_plain(st, mp, TPS, DT, DZ)
    wrappers = (K2.step_column_2m_fused, K2.step_column_2m_fused_packed)
    cases = [(lambda: model(packed), "launch.k3",
              K2.step_column_2m_fused_packed),
             (lambda: model(st), "launch.k4", K2.step_column_2m_fused),
             (lambda: step_column_2m(st, mp, TPS, DT, DZ, impl="fused"),
              "launch.k4", K2.step_column_2m_fused)]
    steps = 3
    for fn, span, wrapper in cases:
        before = _launches(*wrappers)
        trace.reset()
        prof = _profiled(fn, steps)
        assert [a - b for a, b in zip(_launches(*wrappers), before)] == [
            (steps + 1) * (w is wrapper) for w in wrappers]
        totals = trace.totals()
        assert set(totals) == {"step.column2m", "column.prepare", span}
        assert totals["step.column2m"]["count"] == steps
        assert totals["column.prepare"]["count"] == steps
        assert totals[span]["count"] == steps
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e.name for e in events if e.device_type == cuda
                   and not e.name.startswith(("Memcpy", "Memset"))]
        assert len(kernels) == steps
        assert all("column2m_step_kernel" in n for n in kernels)
        runtime = [e.time_range for e in events
                   if e.name.startswith(("cudaLaunchKernel",
                                         "cuLaunchKernel"))]
        for r in (e.time_range for e in events if e.name == span):
            inside = [x for x in runtime
                      if r.start <= x.start and x.end <= r.end]
            assert len(inside) == 1, (span, len(inside))
        out = fn()
        out = out if isinstance(out, ColumnState2M) else (
            K2.unpack_state_2m(out))
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert trace.counter("column2m.packed_bytes") == 0
    trace.reset()


@pytest.mark.parametrize("case", ["transposed", "mixed"])
def test_2m_fields_path_takes_what_the_stack_took(device, case):
    """``step_column_2m(impl="fused")`` on fields the launch check alone
    refuses: non-contiguous ones (a transposed view's), and float32 fields
    mixed with float64 ones (promoted to float64, as ``torch.stack``
    promoted them). One K4 launch a step, bit for bit the plain step of the
    contiguous, promoted state."""
    from cloudmicrophysics_tpu_torch.models.column import step_column_2m

    mp = microphysics_2m_params()
    st = _state_2m(256, 64, device)
    if case == "transposed":
        fields = ColumnState2M(*(t.T.contiguous().T for t in st))
        assert not any(t.is_contiguous() for t in fields)
    else:
        fields = st._replace(q_tot=st.q_tot.double(),
                             n_rai=st.n_rai.double())
        st = ColumnState2M(*(t.double() for t in st))
    ref = K2.step_column_2m_plain(st, mp, TPS, DT, DZ)
    before = _launches(K2.step_column_2m_fused)[0]
    out = step_column_2m(fields, mp, TPS, DT, DZ, impl="fused")
    assert _launches(K2.step_column_2m_fused)[0] == before + 1
    for name, a, b in zip(ColumnState2M._fields, out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# ARG2000 activation (csrc/activation.cu) against its plain version
# ---------------------------------------------------------------------------

def _arg_params():
    from cloudmicrophysics_tpu_torch.parameters import AirProperties
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolActivationParameters,
    )

    return AerosolActivationParameters(), AirProperties(), TPS


def _arg_cell(device, dtype, ncol):
    """The cell ``arg_mam4``'s seeded state at ``ncol`` columns."""
    import sys

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench_h100.drivers import activation as D
    from bench_h100.reference import activation as R
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
        ModeKappa,
    )

    cfg = json.loads((Path(root) / "bench_h100" / "configs"
                      / "atmos_mam4.json").read_text())
    layout = R.Layout(cfg)
    state = D.make_state(cfg, ncol, 2**35 + 89, device, dtype)
    return (layout.distribution(state, ModeKappa, AerosolDistribution),
            layout.air(state))


def _arg_emulator(device, dtype, n=4096):
    """The emulator's dataset draw (models/emulator.py
    ``generate_training_data``): per-sample tensors, no condensate."""
    from cloudmicrophysics_tpu_torch.models import emulator as EM
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
    )

    rng = np.random.default_rng(5)

    def A(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    r_dry = A(10 ** rng.uniform(-8.2, -6.5, (2, n)))
    stdev = A(rng.uniform(1.4, 2.4, (2, n)))
    N_m = A(10 ** rng.uniform(6.5, 9.5, (2, n)))
    kappa = A(rng.uniform(0.1, 1.2, (2, n)))
    w = A(10 ** rng.uniform(-1.5, 0.7, n))
    T = A(rng.uniform(270.0, 300.0, n))
    p = A(rng.uniform(7e4, 1.02e5, n))
    ad = AerosolDistribution(modes=EM._kappa_modes(r_dry, stdev, N_m, kappa))
    return ad, (T, p, w, EM._saturated_q_tot(TPS, T, p), 0.0, 0.0, 0.0, 0.0)


def _arg_two_modes(device, dtype, zero_d=False, b_tensors=False):
    """chip_smoke.py phase 15's two modes (kappa sulfate, B sea salt, Python
    numbers) on a saturated (64, 40) state with no condensate; ``zero_d``:
    phase 16's 0-d air; ``b_tensors``: the sea salt's fraction a tensor a
    point."""
    from cloudmicrophysics_tpu_torch.ops import thermo as TDI
    from cloudmicrophysics_tpu_torch.parameters import aerosol_species as SP
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
        ModeB,
        ModeKappa,
    )

    g = torch.Generator(device=device).manual_seed(1)
    shape = () if zero_d else (64, 40)
    T = 250.0 + 45.0 * torch.rand(shape, generator=g, device=device,
                                  dtype=dtype)
    p = 6e4 + 4e4 * torch.rand(shape, generator=g, device=device,
                               dtype=dtype)
    w = 10 ** (2 * torch.rand(shape, generator=g, device=device,
                              dtype=dtype) - 1)
    p_vs = TDI.saturation_vapor_pressure_over_liquid(TPS, T)
    q_tot = 1 / (1 - TPS.Rv_over_Rd * (p_vs - p) / p_vs)
    frac = (0.5 + 0.5 * torch.rand(shape, generator=g, device=device,
                                   dtype=dtype)) if b_tensors else 1.0
    su, ss = SP.Sulfate(), SP.Seasalt()
    ad = AerosolDistribution(modes=(
        ModeKappa(r_dry=0.05e-6, stdev=2.0, N=100e6, vol_mix_ratio=(1.0,),
                  mass_mix_ratio=(1.0,), molar_mass=(su.M,),
                  kappa=(su.kappa,)),
        ModeB(r_dry=1.5e-6, stdev=2.1, N=1e6, mass_mix_ratio=(frac,),
              soluble_mass_frac=(ss.epsilon,), osmotic_coeff=(ss.phi,),
              molar_mass=(ss.M,), dissoc=(ss.nu,),
              aerosol_density=(ss.rho,))))
    z = 0.0 if zero_d else torch.zeros_like(T)
    return ad, (T, p, w, q_tot, z, z, 0.0, 0.0)


def _arg_broadcast(device, dtype):
    """Fields of other shapes than the state's (64, 40): the air's T, p
    and q_tot a column, w a level, a mode's N a level and its r_dry a
    column, a kappa a 0-d tensor and a volume fraction transposed, each
    expanded and made contiguous by the wrapper."""
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
        ModeKappa,
    )

    g = torch.Generator(device=device).manual_seed(2)

    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                           dtype=dtype)

    T, p = u(260.0, 295.0, (64, 1)), u(7e4, 1e5, (64, 1))
    vol = u(0.2, 0.8, (40, 64)).t()
    ad = AerosolDistribution(modes=(
        ModeKappa(r_dry=u(3e-8, 1e-7, (64, 1)), stdev=1.8,
                  N=u(1e8, 1e9, (40,)), vol_mix_ratio=(vol, 1 - vol),
                  mass_mix_ratio=(vol, 1 - vol), molar_mass=(0.115, 0.25),
                  kappa=(torch.tensor(0.507, device=device, dtype=dtype),
                         0.14)),))
    return ad, (T, p, u(0.2, 2.0, (40,)), u(5e-3, 1.2e-2, (64, 1)),
                u(0.0, 1e-3, (64, 40)), 0.0, u(0.0, 1e8, (64, 40)), 0.0)


ARG_CASES = {
    "arg_mam4 (64, 72)": lambda d, t: _arg_cell(d, t, 64),
    "arg_mam4 ragged (37, 72)": lambda d, t: _arg_cell(d, t, 37),
    "emulator draw": _arg_emulator,
    "phase 15 two modes": _arg_two_modes,
    "ModeB fraction a point": lambda d, t: _arg_two_modes(d, t,
                                                          b_tensors=True),
    "phase 16 0-d air": lambda d, t: _arg_two_modes(d, t, zero_d=True),
    "broadcast fields": _arg_broadcast,
}


def _bits_off(got, want):
    """Entries of ``got`` not bit-equal to ``want``, and the largest
    difference over ``want``'s largest magnitude."""
    diff = got != want
    scale = float(want.abs().max()) or 1.0
    return int(diff.sum()), float((got - want).abs().max()) / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(ARG_CASES))
def test_arg2000_kernels_are_the_plain_version_bit_for_bit(device, case,
                                                          dtype):
    """N_activated_per_mode and M_activated_per_mode on the card: one launch
    each, bit for bit the eager plain version, with the counters of a
    kernel call."""
    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA

    ap, aip, tps = _arg_params()
    ad, air = ARG_CASES[case](device, dtype)
    names = ("launches.arg_number", "launches.arg_mass",
             "activation.kernel_points", "activation.points",
             "activation.smax_points")
    before = {n: trace.counter(n) for n in names}
    n_act = AA.N_activated_per_mode(ap, ad, aip, tps, *air)
    m_act = AA.M_activated_per_mode(ap, ad, aip, tps, *air)
    points = n_act[0].numel()
    assert {n: trace.counter(n) - before[n] for n in names} == {
        "launches.arg_number": 1, "launches.arg_mass": 1,
        "activation.kernel_points": points, "activation.points": points,
        "activation.smax_points": 2 * points}
    want = (AA.N_activated_per_mode_plain(ap, ad, aip, tps, *air)
            + AA.M_activated_per_mode_plain(ap, ad, aip, tps, *air))
    for i, (got, ref) in enumerate(zip(n_act + m_act, want)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.equal(got, ref), (i, _bits_off(got, ref))


def test_arg2000_cuda_rejections(device):
    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA

    ap, aip, tps = _arg_params()
    ad, air = _arg_two_modes(device, torch.float32)
    half = tuple(x.half() if isinstance(x, torch.Tensor) else x for x in air)
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        AA.N_activated_per_mode(ap, ad, aip, tps, *half)
    cpu_w = list(air)
    cpu_w[2] = air[2].cpu()
    with pytest.raises(ValueError, match="tensors on cuda"):
        AA.M_activated_per_mode(ap, ad, aip, tps, *cpu_w)
    # the path follows every field, not T alone: a 0-d CPU T (which eager
    # code would mix with CUDA tensors), a Python-number T, or a CPU state
    # with a mode field on the card all take the kernel's path and raise
    zero_d_T = list(air)
    zero_d_T[0] = torch.tensor(280.0, dtype=torch.float32)
    for fn in (AA.N_activated_per_mode, AA.M_activated_per_mode):
        with pytest.raises(ValueError, match="tensors on cuda"):
            fn(ap, ad, aip, tps, *zero_d_T)
        with pytest.raises(NotImplementedError, match="T as a tensor"):
            fn(ap, ad, aip, tps, 280.0, *air[1:])
    ad_b, air_b = _arg_two_modes(device, torch.float32, b_tensors=True)
    cpu_air = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                    for x in air_b)
    with pytest.raises(ValueError, match="tensors on cuda"):
        AA.N_activated_per_mode(ap, ad_b, aip, tps, *cpu_air)
    # a field that requires a gradient: the kernel tracks none, so it
    # raises while autograd records and launches under no_grad
    grad_w = list(air)
    grad_w[2] = air[2].clone().requires_grad_()
    for fn in (AA.N_activated_per_mode, AA.M_activated_per_mode):
        with pytest.raises(NotImplementedError, match="no gradient"):
            fn(ap, ad, aip, tps, *grad_w)
        with torch.no_grad():
            got = fn(ap, ad, aip, tps, *grad_w)
        want = fn(ap, ad, aip, tps, *air)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The point-wise fused P3 tendencies (column_p3.cu built with -DK5_TEND)
# ---------------------------------------------------------------------------

def _tend_args(state, loglam, seed=2**33 + 26):
    """The tendency call's arguments from a P3 state of any shape: its
    eleven fields, log lambda and a per-point INP log shift drawn from
    N(0, 1.37^2), the spread of the cell ``p3_tend_gl40``."""
    rho = state[0]
    g = torch.Generator(device=rho.device)
    g.manual_seed(seed)
    shift = torch.randn(rho.shape, generator=g, device=rho.device,
                        dtype=rho.dtype) * 1.37
    return list(state) + [loglam, shift]


def _tend_same(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def _tend_cell_state(device, dtype, ncol):
    """The cell ``p3_tend_gl40``'s seeded host state at ``ncol`` columns."""
    import sys

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench_h100.drivers import p3_tendencies as D

    cfg = json.loads((Path(root) / "bench_h100" / "configs"
                      / "climaatmos_2mp3.json").read_text())
    return D.make_state(cfg, ncol, 2**35 + 26, device, dtype)


# every K5 variant (kernels/column_p3.variant: order, slope law, aspect
# ratio, ice rain PSD, dtype) and both warm-rain templates of the rates
# kernel, on a ragged (37, 19) state with warm ice-free cells
TEND_SCOPE = {
    "GL-16": (dict(), torch.float32),
    "GL-40": (dict(order=40), torch.float32),
    "GL-40 float64": (dict(order=40), torch.float64),
    "CG-100": (dict(order=100), torch.float32),
    "CG-5 float64": (dict(order=5), torch.float64),
    "GL-4": (dict(order=4), torch.float32),
    "SlopeConstant": (dict(slope_law="constant"), torch.float32),
    "NoAspectRatio": (dict(aspect_ratio="NoAspectRatio"), torch.float32),
    "unlimited ice rain PSD": (dict(ice_rain_limited=False), torch.float32),
    "float64 options": (dict(slope_law="constant",
                             aspect_ratio="NoAspectRatio",
                             ice_rain_limited=False, is_limited=False,
                             rain_velocity="chen2022"), torch.float64),
    "unlimited rain, Chen 2022": (dict(is_limited=False,
                                       rain_velocity="chen2022"),
                                  torch.float32),
}


@pytest.mark.parametrize("name", list(TEND_SCOPE))
def test_p3_tendency_route_is_the_eager_path_bit_for_bit(device, name):
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )

    opts, dtype = TEND_SCOPE[name]
    mp = _p3_scope(**opts)
    st = _state_p3(37, 19, device, dtype)
    loglam = K5.loglambda_p3_fused(st, mp, TPS)
    args = _tend_args(st, loglam)
    names = ("tendencies.points", "tendencies.kernel_points",
             "launches.launch_tend_bounds", "launches.launch_nodes",
             "launches.launch_tend_rates")
    before = [trace.counter(n) for n in names]
    got = bulk_microphysics_tendencies(mp, TPS, *args)
    counted = [trace.counter(n) - b for n, b in zip(names, before)]
    assert counted == [37 * 19, 37 * 19, 1, 1, 1]
    _tend_same(got, bulk_tendencies_2m_plain(mp, TPS, *args))
    # no shift is a zero shift; a flat or 3-D view steps the same points
    _tend_same(bulk_microphysics_tendencies(mp, TPS, *args[:-1]),
               bulk_tendencies_2m_plain(mp, TPS, *args[:-1]))
    flat = bulk_microphysics_tendencies(mp, TPS,
                                        *(a.reshape(-1) for a in args))
    _tend_same(type(got)(*(t.reshape(37, 19) for t in flat)), got)
    cube = bulk_microphysics_tendencies(
        mp, TPS, *(a.reshape(37, 19, 1) for a in args))
    assert cube.dq_ice_dt.shape == (37, 19, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_p3_tendency_route_at_the_cells_size(device, dtype):
    """The cell ``p3_tend_gl40``'s whole (86400, 63) grid through the route,
    held bit for bit to the eager path on 512 columns spread over it (the
    call is point-wise: a column's rates depend on that column alone)."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=40)
    state = _tend_cell_state(device, dtype, 86400)
    fields = ColumnStateP3(*state[:11])
    loglam = K5.loglambda_p3_fused(fields, mp, TPS)
    args = list(fields) + [loglam, state.inpc_log_shift]
    before = [trace.counter(n) for n in ("tendencies.points",
                                         "tendencies.kernel_points")]
    got = bulk_microphysics_tendencies(mp, TPS, *args)
    points, kernel_points = (trace.counter(n) - b for n, b in zip(
        ("tendencies.points", "tendencies.kernel_points"), before))
    assert points == kernel_points == 86400 * 63
    cols = torch.linspace(0, 86399, 512, device=device).long()
    want = bulk_tendencies_2m_plain(mp, TPS, *(a[cols] for a in args))
    _tend_same(type(got)(*(t[cols] for t in got)), want)
    del got, want, state, args


def test_p3_tendency_route_refuses_tracked_fields(device):
    """A field that requires a gradient raises on the card (the kernels
    track none) and launches nothing; the plain version differentiates, and
    under no_grad the same fields launch, bit for bit the eager answer."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = _state_p3(64, 16, device)
    args = _tend_args(st, K5.loglambda_p3_fused(st, mp, TPS))
    args[1] = args[1].clone().requires_grad_()
    before = _launches(K5.p3_tendencies_fused)
    with pytest.raises(NotImplementedError, match="track no derivative"):
        bulk_microphysics_tendencies(mp, TPS, *args)
    assert _launches(K5.p3_tendencies_fused) == before
    eager = bulk_tendencies_2m_plain(mp, TPS, *args)
    (g,) = torch.autograd.grad(eager.dq_ice_dt.sum(), args[1])
    assert bool(torch.isfinite(g).all())
    with torch.no_grad():
        fused = bulk_microphysics_tendencies(mp, TPS, *args)
    assert _launches(K5.p3_tendencies_fused) == [before[0] + 1]
    _tend_same(fused, type(eager)(*(t.detach() for t in eager)))


# fields as a host may hand them (index in the call: value from the state
# ``st`` and log lambda ``ll``), each held bit for bit to the eager code on
# the same call
TEND_FORMS = {
    "ice, log lambda and shift None": lambda st, ll: {
        k: None for k in range(7, 13)},
    "numbers": lambda st, ll: {11: 9.5, 12: -0.75},
    "broadcast profile and columns": lambda st, ll: {
        1: st[1][:1], 2: st[2][:, :1].contiguous(), 11: ll[:1, :1]},
    "0-d tensors": lambda st, ll: {
        6: st[6].new_tensor(2.5e5), 12: st[0].new_tensor(0.3)},
    "strided": lambda st, ll: {
        3: st[3].t().contiguous().t(), 11: ll.t().contiguous().t()},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", list(TEND_FORMS))
def test_p3_tendency_route_takes_the_fields_as_the_eager_code(device, form,
                                                              dtype):
    """None fields, Python numbers, 0-d tensors, broadcast shapes and
    strided fields: the route (one launch) gives the eager code's answer to
    the same call bit for bit, in the broadcast shape."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=16)
    st = _state_p3(37, 19, device, dtype)
    ll = K5.loglambda_p3_fused(st, mp, TPS)
    args = _tend_args(st, ll)
    for k, v in TEND_FORMS[form](st, ll).items():
        args[k] = v
    before = _launches(K5.p3_tendencies_fused)
    got = bulk_microphysics_tendencies(mp, TPS, *args)
    assert _launches(K5.p3_tendencies_fused) == [before[0] + 1]
    want = bulk_tendencies_2m_plain(mp, TPS, *args)
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == (37, 19) and a.dtype == dtype, name
        assert torch.equal(a, b.expand_as(a)), name


def test_p3_tendency_cuda_rejections(device):
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = _state_p3(64, 16, device)
    args = _tend_args(st, K5.loglambda_p3_fused(st, mp, TPS))
    cpu_T = list(args)
    cpu_T[1] = args[1].cpu()
    with pytest.raises(ValueError, match="differ in device or dtype"):
        bulk_microphysics_tendencies(mp, TPS, *cpu_T)
    with pytest.raises(ValueError, match="differ in device or dtype"):
        bulk_microphysics_tendencies(mp, TPS, *args[:-1], args[-1].double())
    with pytest.raises(ValueError, match="differ in device or dtype"):
        bulk_microphysics_tendencies(mp, TPS, *args[:-1],
                                     torch.tensor(0.3, dtype=torch.float32))
    with pytest.raises(ValueError, match="do not broadcast"):
        bulk_microphysics_tendencies(mp, TPS, *args[:-2], args[-2][:, :3])
    with pytest.raises(TypeError, match="not str"):
        bulk_microphysics_tendencies(mp, TPS, *args[:-2], "9")
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        bulk_microphysics_tendencies(mp, TPS, *(a.half() for a in args))


def _with_ice(fields, where, q_ice=1e-4, n_ice=1e5):
    """``fields`` (a P3 state's eleven) with ice at every point of the mask
    ``where`` (of their shape) and none elsewhere: a point keeps its own ice
    where it has some, else gets unrimed ice of ``q_ice`` and ``n_ice``."""
    has = (fields[7] > 0) & (fields[8] > 0)
    zero = torch.zeros((), dtype=fields[0].dtype, device=fields[0].device)
    out = list(fields)
    out[7] = torch.where(where, torch.where(has, fields[7], q_ice), zero)
    out[8] = torch.where(where, torch.where(has, fields[8], n_ice), zero)
    for k in (9, 10):
        out[k] = torch.where(where & has, fields[k], zero)
    return ColumnStateP3(*out)


def _node_pass_points(fields, order):
    """The points whose K5b node pass a tendency call runs: every point of
    a warp (32 // G cells, G K5b's lanes a cell) with a point that holds
    ice, the test of bulk_tendencies_2m's has_ice."""
    from cloudmicrophysics_tpu_torch.utils.special import machine_eps

    eps = machine_eps(fields[0].dtype)
    has = ((fields[7].reshape(-1).clamp_min(0) > eps)
           & (fields[8].reshape(-1).clamp_min(0) > eps))
    per_warp = 32 // K5.lanes_per_cell(order)
    pad = -has.numel() % per_warp
    warps = torch.cat([has, has.new_zeros(pad)]).view(-1, per_warp)
    runs = warps.any(dim=1, keepdim=True).expand_as(warps).reshape(-1)
    return int(runs[:has.numel()].sum()), int(has.sum())


def _tend_layout(name, device, dtype):
    """``(fields, order)`` of a named ice layout: none, at every point, the
    cell ``p3_tend_gl40``'s contiguous third, every other point, and at
    GL-4 (several cells a K5b warp) in one point of each pair of every
    other pair, so that a warp of two cells runs with one icy cell and
    warps without ice skip."""
    if name == "cell":
        return ColumnStateP3(*_tend_cell_state(device, dtype, 256)[:11]), 40
    base = _state_p3(64, 63, device, dtype)
    flat = torch.arange(base.rho.numel(), device=device).view_as(base.rho)
    masks = {"no ice": flat < 0, "all ice": flat >= 0,
             "every other point": flat % 2 == 0,
             "GL-4, two cells a warp": flat % 4 == 0}
    order = 4 if name.startswith("GL-4") else 40
    return _with_ice(base, masks[name]), order


TEND_ICE_LAYOUTS = ("no ice", "all ice", "cell", "every other point",
                    "GL-4, two cells a warp")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", TEND_ICE_LAYOUTS)
def test_p3_tendency_node_pass_skips_warps_without_ice(device, layout,
                                                        dtype):
    """K5b of the tendency build runs the node pass only in warps that hold
    ice. The route stays bit for bit the eager code at every ice layout,
    also with its three kernels run on a scratch record filled with NaN
    (no row a skipped warp leaves unwritten reaches a rate), and
    ``tendencies.ice_points`` rises by the points of the warps that ran: the
    host's count of points with ice where a warp is one cell (GL-40), 0
    and every point at the extremes."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )

    fields, order = _tend_layout(layout, device, dtype)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    args = _tend_args(fields, K5.loglambda_p3_fused(fields, mp, TPS))
    ran, icy = _node_pass_points(fields, order)
    n = fields.rho.numel()
    if layout == "no ice":
        assert ran == icy == 0
    elif layout == "all ice":
        assert ran == icy == n
    elif order == 40:
        assert ran == icy and 0 < icy < n
    else:
        assert icy < ran < n
    before = trace.counter("tendencies.ice_points")
    got = bulk_microphysics_tendencies(mp, TPS, *args)
    assert trace.counter("tendencies.ice_points") - before == ran
    want = bulk_tendencies_2m_plain(mp, TPS, *args)
    _tend_same(got, want)

    lib = K5._library("tend", K5.variant(mp, dtype))
    plan = K5.launch_plan(n, 1, order, 1, dtype)
    params = K5.kernel_params_p3(mp, TPS, device=device, dtype=dtype)
    flat = ColumnStateP3(*(a.reshape(-1) for a in args[:11]))
    scratch = torch.full(plan.scratch_shape, float("nan"), dtype=dtype,
                         device=device)
    out = torch.empty((len(K5.TEND_FIELDS), n), dtype=dtype, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    K5.launch_tend_bounds(lib, flat, args[11].reshape(-1), scratch, params,
                          plan, device)
    K5.launch_nodes(lib, flat, scratch, params, plan, device, count)
    K5.launch_tend_rates(lib, flat, args[12].reshape(-1), out, scratch,
                         params, K5.warm_variant(mp), device)
    assert int(count) == ran
    _tend_same(type(want)(*(r.view_as(fields.rho) for r in out)), want)


def test_p3_tendency_call_makes_no_host_sync(device):
    """A tendency call (after its first, which builds and loads) queues its
    kernels and adds to ``tendencies.ice_points`` on the device without a
    host sync; reading the counter waits for the device."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
    )

    mp = microphysics_2m_params(with_ice=True, quadrature_order=40)
    fields = ColumnStateP3(*_tend_cell_state(device, torch.float32, 64)[:11])
    args = _tend_args(fields, K5.loglambda_p3_fused(fields, mp, TPS))
    bulk_microphysics_tendencies(mp, TPS, *args)
    before = trace.counter("tendencies.ice_points")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            bulk_microphysics_tendencies(mp, TPS, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ran, _ = _node_pass_points(fields, 40)
    assert trace.counter("tendencies.ice_points") - before == 2 * ran > 0


def _tend_spans_probe(steps=3):
    """Three tendency calls under a CPU and CUDA profiler: the trace's
    totals, the device's kernels and, for each launch span, the runtime
    launch calls inside each of its ranges and whether ``tendencies.p3``
    holds the range."""
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
    )

    device = torch.device("cuda", 0)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st = _state_p3(256, 64, device)
    args = _tend_args(st, K5.loglambda_p3_fused(st, mp, TPS))
    trace.reset()
    prof = _profiled(lambda: bulk_microphysics_tendencies(mp, TPS, *args),
                     steps)
    totals = trace.totals()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    runtime = [e.time_range for e in events
               if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    outer = [e.time_range for e in events if e.name == "tendencies.p3"]
    spans = {}
    for name in ("launch.p3tend_bounds", "launch.k5b", "launch.p3tend_rates"):
        ranges = [e.time_range for e in events if e.name == name]
        spans[name] = {
            "count": totals[name]["count"],
            "inside": [sum(r.start <= x.start and x.end <= r.end
                           for x in runtime) for r in ranges],
            "held": [any(o.start <= r.start and r.end <= o.end
                         for o in outer) for r in ranges]}
    trace.reset()
    return {"outer": totals["tendencies.p3"]["count"], "spans": spans,
            "kernels": [e.name for e in events if e.device_type == cuda
                        and not e.name.startswith(("Memcpy", "Memset"))]}


def test_p3_tendency_spans_hold_their_launches_on_the_profiler_clock(device):
    """Under the profiler, a tendency call's three launches each lie in
    their span (``launch.p3tend_bounds``, ``launch.k5b``,
    ``launch.p3tend_rates``) inside ``tendencies.p3``, and the device ran
    the three kernels a call, the tendency build's by name. The profile is
    taken in a fresh process: run after the whole file's earlier tests,
    this process's profiler recorded the spans but no device kernel."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    code = (f"import sys, json; sys.path[:0] = [{str(root)!r}, "
            f"{str(root / 'tests')!r}]; import test_torch_cuda as T; "
            "print(json.dumps(T._tend_spans_probe(3)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    steps = 3
    assert got["outer"] == steps
    kernels = got["kernels"]
    assert len(kernels) == 3 * steps
    for part in ("column_p3_bounds_kernel", "column_p3_nodes_kernel",
                 "column_p3_tend_rates_kernel"):
        assert sum(part in k for k in kernels) == steps, part
    for name, span in got["spans"].items():
        assert span["count"] == steps, name
        assert span["inside"] == [1] * steps, name
        assert span["held"] == [True] * steps, name


def test_k5b_is_one_code_in_the_column_and_tendency_builds(device):
    """The node pass the tendency build launches is the column build's K5b
    behind the tendency build's skip. Built without the skip
    (``-DK5_TEND_NO_SKIP``), the tendency build's K5b is the column
    build's instruction for instruction: opcode, guard and branch target,
    in order. With it, it holds the same floating-point arithmetic and the
    same stores, opcode for opcode (the compiler orders them differently
    around the skip), plus the warp's vote, the block's count of its
    running cells and its one atomic add."""
    from collections import Counter

    from cloudmicrophysics_tpu_torch.kernels import _build, opcount

    v = K5.Variant(order=40)
    no_skip = _build.build(K5.SOURCE, "column_p3_params.h", K5.header(v),
                           K5._flags(v, "tend") + ("-DK5_TEND_NO_SKIP",))

    def node_pass(library):
        sass = opcount.disassemble(library)
        return [i for i in opcount.parse_sass(sass)
                if "column_p3_nodes_kernel" in i.function]

    def in_order(body):
        # each branch target as the place of the instruction it names (the
        # labels are numbered across the library)
        at = {lab: k for k, i in enumerate(body) for lab in i.labels}
        return [(i.opcode, i.predicated, at.get(i.target)) for i in body]

    def kept(body):
        return Counter(i.opcode for i in body
                       if i.opcode.split(".")[0] in (
                           "FADD", "FMUL", "FFMA", "MUFU", "DADD", "DMUL",
                           "DFMA", "STG", "STS", "ST"))

    def skip(body):
        ops = Counter(i.opcode for i in body)
        return [sum(n for k, n in ops.items() if k.startswith(prefix))
                for prefix in ("VOTE.ANY", "BAR.RED.POPC", "REDG.E.ADD")]

    column = node_pass(K5.library_path("kernel", v))
    tend = node_pass(K5.library_path("tend", v))
    assert column and in_order(column) == in_order(node_pass(no_skip))
    assert kept(column) and kept(column) == kept(tend)
    assert skip(column) == [0, 0, 0]
    assert skip(tend) == [1, 1, 1]
