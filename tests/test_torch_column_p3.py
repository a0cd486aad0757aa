"""The 2M + P3 column step of the port against the JAX package, and the
module that holds the fused CUDA kernel (kernels/column_p3.py).

On the CPU the kernel wrapper and ``ColumnP3Step`` take the plain version;
the kernel itself is compared with that plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py. Tolerance of the float64
comparisons with the JAX step: rtol 1e-9 with an absolute floor of 1e-12
of the largest magnitude (a few ULP of torch/XLA exp/log/pow carried
through the fixed-trip solvers); infinities of log lambda must coincide.
The warm start is given a guess away from the root (the previous solve
plus a seeded offset): at the root itself the sign of the residual, and so
the bracket the solver keeps, is decided by the last bit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.kernels import column_p3 as TK
from cloudmicrophysics_tpu_torch.models import column as TC

TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
DT, DZ = 1.0, 100.0
RTOL, ATOL_REL = 1e-9, 1e-12
MP_J = JP.microphysics_2m_params(with_ice=True, quadrature_order=4)
MP_T = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(MP_J))


def _arrays(ncol=8, nlev=6, seed=5):
    """rho and T profiles (warm at the bottom, cold aloft), ice only below
    freezing, rain only where its freezing stays moderate; a column without
    ice and one of unrimed ice."""
    rng = np.random.default_rng(seed)
    sh = (ncol, nlev)
    ones = np.ones((ncol, 1))
    T = np.linspace(285.0, 240.0, nlev)[None] * ones
    q_ice = np.where(T < 273.15, 10 ** rng.uniform(-6, -3, sh), 0.0)
    q_ice[0] = 0.0
    q_rim = q_ice * rng.uniform(0, 0.95, sh)
    q_rim[1] = 0.0
    q_lcl = np.where(T > 245.0, 1e-3 * rng.random(sh), 0.0)
    q_rai = np.where(T > 263.0, 5e-4 * rng.random(sh), 0.0)
    return dict(
        rho=np.linspace(1.2, 0.5, nlev)[None] * ones, T=T,
        q_tot=q_lcl + q_rai + q_ice + 6e-3 * rng.random(sh),
        q_lcl=q_lcl, n_lcl=np.where(q_lcl > 0, 1e8 * rng.random(sh), 0.0),
        q_rai=q_rai, n_rai=np.where(q_rai > 0, 1e6 * rng.random(sh), 0.0),
        q_ice=q_ice,
        n_ice=np.where(q_ice > 0, q_ice / 10 ** rng.uniform(-11, -8, sh), 0),
        q_rim=q_rim, b_rim=q_rim / rng.uniform(100, 900, sh),
        guess_offset=rng.uniform(-0.5, 0.5, sh))


def _jax_state(a):
    return JC.ColumnStateP3(*(jnp.asarray(a[k]) for k in JC.ColumnStateP3._fields))


def _torch_state(a, dtype=torch.float64):
    return TP.column_state_p3_from_numpy(a, device="cpu", dtype=dtype)


def _assert_close(out, ref, what):
    for name, a, b in zip(ref._fields, out, ref):
        b = np.asarray(b)
        atol = ATOL_REL * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=f"{what}: {name}")


def _assert_loglam(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, err_msg=what)


@pytest.fixture(scope="module")
def jax_steps():
    """One cold and one warm-started JAX step (one compile)."""
    a = _arrays()

    def two(st, offset):
        new, ll = JC.step_column_p3(st, MP_J, TPS_J, DT, DZ)
        guess = ll + offset
        new2, ll2 = JC.step_column_p3(st, MP_J, TPS_J, DT, DZ, guess)
        return new, ll, guess, new2, ll2

    out = jax.jit(two)(_jax_state(a), jnp.asarray(a["guess_offset"]))
    return a, out


def test_step_column_p3_cold_matches_jax(jax_steps):
    a, (ref, ll_ref, _, _, _) = jax_steps
    out, ll = TC.step_column_p3(_torch_state(a), MP_T, TPS_T, DT, DZ)
    assert isinstance(out, TC.ColumnStateP3)
    _assert_close(out, ref, "cold step")
    _assert_loglam(ll, ll_ref, "cold log lambda")
    assert torch.isneginf(ll[0]).all() and torch.isfinite(ll[2:, 3:]).all()


def test_step_column_p3_warm_start_matches_jax(jax_steps):
    a, (_, _, guess, ref, ll_ref) = jax_steps
    out, ll = TC.step_column_p3(_torch_state(a), MP_T, TPS_T, DT, DZ,
                                torch.tensor(np.asarray(guess)))
    _assert_close(out, ref, "warm step")
    _assert_loglam(ll, ll_ref, "warm log lambda")


def test_col_chunks_equal_unchunked():
    st = _torch_state(_arrays())
    whole, ll = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ)
    parts, ll2 = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, col_chunks=2)
    # identical math; CPU kernels may vectorize a chunk's tail differently,
    # so equal to the last few bits
    for name, x, y in zip(st._fields, parts, whole):
        torch.testing.assert_close(x, y, rtol=1e-13, atol=0, msg=name)
    torch.testing.assert_close(ll2, ll, rtol=1e-13, atol=0)
    guess = torch.where(torch.isfinite(ll), ll + 0.2, ll)
    a, la = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, guess, col_chunks=4)
    b, lb = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, guess)
    torch.testing.assert_close(la, lb, rtol=1e-13, atol=0)


@pytest.mark.parametrize("chunks", [3, 5])
def test_col_chunks_must_divide_ncol(chunks):
    st = _torch_state(_arrays())
    with pytest.raises(ValueError, match="does not divide"):
        TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, col_chunks=chunks)


def test_step_column_p3_impls():
    st = _torch_state(_arrays())
    eager = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ)
    # CPU tensors: the fused form runs the plain version
    fused = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, impl="fused")
    for x, y in zip(eager[0] + (eager[1],), fused[0] + (fused[1],)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown impl"):
        TC.step_column_p3(st, MP_T, TPS_T, DT, DZ, impl="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_p3_step_module_equals_step(dtype):
    st = _torch_state(_arrays(), dtype)
    model = TC.ColumnP3Step(MP_T, TPS_T, DT, DZ, device="cpu")
    assert model.params.dtype == torch.float32
    assert model.block(torch.float32) is model.params
    # the buffer a state steps with is in the state's dtype
    block = model.block(dtype)
    assert block.dtype == dtype and model.block(dtype) is block
    torch.testing.assert_close(
        block, TK.kernel_params_p3(MP_T, TPS_T, dtype=dtype), rtol=0, atol=0)
    before = trace.counter("launches.step_column_p3_fused")
    out, ll = model(st)
    ref, ll_ref = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ)
    for x, y in zip(out + (ll,), ref + (ll_ref,)):
        assert torch.equal(x, y)
    out2, ll2 = model(out, ll)
    ref2, ll_ref2 = TC.step_column_p3(ref, MP_T, TPS_T, DT, DZ, ll_ref)
    for x, y in zip(out2 + (ll2,), ref2 + (ll_ref2,)):
        assert torch.equal(x, y)
    # the CPU path launches nothing
    assert trace.counter("launches.step_column_p3_fused") == before


def test_fused_wrapper_checks_shapes_and_tiling():
    st = _torch_state(_arrays(), torch.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        TK.step_column_p3_fused(st, MP_T, TPS_T, DT, DZ, block_cols=3)
    with pytest.raises(ValueError, match="every field"):
        TK.step_column_p3_fused(st, MP_T, TPS_T, DT, DZ,
                                loglambda_guess=torch.zeros(8, 5),
                                block_cols=8)


# ---------------------------------------------------------------------------
# what the CUDA path accepts, and the kernel's parameter buffer
# ---------------------------------------------------------------------------

def _p3(ice_rain_limited=True, **kw):
    mp = TP.microphysics_2m_params(with_ice=True, **kw)
    if ice_rain_limited:
        return mp
    return dataclasses.replace(mp, ice=dataclasses.replace(
        mp.ice, rain_pdf=dataclasses.replace(mp.ice.rain_pdf,
                                             is_limited=False)))


# the quadrature orders the CUDA path is held to: every Gauss-Legendre order
# of build_quadrature, and Chebyshev-Gauss orders where 32 does not divide
# 4N and N is odd (5, 25) and the reference default (100)
SCOPE_ORDERS = (4, 8, 16, 32, 40, 64, 5, 25, 100)


@pytest.mark.parametrize("mp,nlev,dtype,match", [
    (TP.microphysics_2m_params(), 16, torch.float32, "mp.ice"),
    (TP.microphysics_1m_params(), 16, torch.float32, "mp.ice"),
    (_p3(ice_nucleation=TP.Mohler2006()), 16, torch.float32,
     "Frostenberg2023"),
    (_p3(), 16, torch.float16, "float32 and float64"),
    (_p3(), 16, torch.bfloat16, "float32 and float64"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, nlev, dtype, match):
    # only what the JAX step cannot run either (tests/
    # test_torch_column_p3_scope.py holds both packages to it)
    with pytest.raises(NotImplementedError, match=match):
        TK._check_supported(mp, nlev, dtype)


@pytest.mark.parametrize("order", SCOPE_ORDERS)
@pytest.mark.parametrize("options", [
    {}, dict(is_limited=False, rain_velocity="chen2022"),
    dict(slope_law="constant"), dict(aspect_ratio="NoAspectRatio"),
    dict(ice_rain_limited=False), dict(dtype=torch.float64),
    dict(nlev=512)])
def test_cuda_path_accepts_its_scope(order, options):
    options = dict(options)
    dtype = options.pop("dtype", torch.float32)
    nlev = options.pop("nlev", 128)
    mp = _p3(quadrature_order=order, **options)
    TK._check_supported(mp, nlev, dtype)
    v = TK.variant(mp, dtype)
    assert v == TK.Variant(str(dtype).removeprefix("torch."), order,
                           options.get("slope_law") == "constant",
                           "aspect_ratio" not in options,
                           options.get("ice_rain_limited", True))
    header = TK.header(v)
    for macro, value in (("K5_REAL", _build.c_type(dtype)),
                         ("K5_ORDER", order),
                         ("K5_SLOPE_CONSTANT", int(v.slope_constant)),
                         ("K5_OBLATE", int(v.oblate)),
                         ("K5_ICE_RAIN_LIMITED", int(v.ice_rain_limited))):
        assert f"#define {macro} {value}\n" in header
    plan = TK.launch_plan(8, nlev, order, 8)
    assert plan.epilogue_levels == min(nlev, TK.EPILOGUE_THREADS)
    params = TK.kernel_params_p3(mp, TPS_T, dtype=dtype)
    assert params.dtype == dtype
    assert params.shape == (len(TK.PARAM_NAMES) + TK._table_len(order),)


def test_variant_tags_and_headers_differ():
    tags = {TK.variant(_p3(quadrature_order=o), dt).tag()
            for o in (16, 40, 100) for dt in (torch.float32, torch.float64)}
    assert "f32 GL-16" in tags and "f64 CG-100" in tags and len(tags) == 6
    assert TK.Variant(slope_constant=True, oblate=False,
                      ice_rain_limited=False).tag() == (
        "f32 GL-16 SlopeConstant NoAspectRatio unlimited ice rain PSD")
    headers = {TK.header(TK.Variant(order=o)) for o in (4, 5, 16)}
    assert len(headers) == 3
    with pytest.raises(ValueError, match="at least 1"):
        TK.header(TK.Variant(order=0))


@pytest.mark.parametrize("order", SCOPE_ORDERS)
def test_kernel_params_buffer(order):
    mp = _p3(quadrature_order=order)
    p = TK.kernel_params_p3(mp, TPS_T)
    n = len(TK.PARAM_NAMES)
    assert p.dtype == torch.float32
    assert p.shape == (n + TK._table_len(order),)
    assert bool(torch.isfinite(p).all())
    values = TK._param_values_p3(mp, TPS_T)
    for i, name in enumerate(TK.PARAM_NAMES):
        assert p[i].item() == float(np.float32(values[name])), name
    # the 2M list comes first, so the shared warm-rain code reads the same
    # indices in both kernels
    from cloudmicrophysics_tpu_torch.kernels import column2m as K2M

    assert TK.PARAM_NAMES[:len(K2M.PARAM_NAMES)] == K2M.PARAM_NAMES
    # tables: the ice rule's nodes first
    y, w = mp.ice.quad.nodes_weights()
    np.testing.assert_array_equal(p[n:n + order].numpy(),
                                  y.ravel().astype(np.float32))
    np.testing.assert_array_equal(p[n + order:n + 2 * order].numpy(),
                                  w.ravel().astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_params_thresholds_are_the_eager_steps(dtype):
    """The eps-derived constants and the tail probabilities of the buffer
    are those the eager step of ``dtype`` forms: machine eps of ``dtype``,
    the ice bounds' ``p`` and ``1 - p`` as tensors of it
    (ops/p3.py:integral_bounds), the cloud bounds' ``1 - p`` taken of a
    tensor of it (ops/m2.py:size_distribution_bounds_cloud)."""
    p = TK.kernel_params_p3(_p3(quadrature_order=8), TPS_T, dtype=dtype)
    at = {name: p[i] for i, name in enumerate(TK.PARAM_NAMES)}
    fi = torch.finfo(dtype)
    eps = fi.eps

    def t(v):
        return torch.tensor(v, dtype=dtype)

    for name, want in (
            ("EPS_MACH", t(eps)), ("EM", t(eps)), ("TINY", t(fi.tiny)),
            ("ONE_M_EPS", t(1 - eps)), ("EPS2", t(eps**2)),
            ("TWO_EPS", t(2 * eps)), ("BIG", t(fi.max)),
            ("SGS_UPPER", t(min(1.0 - eps, 42.0 * eps))),
            ("SGS_LO", t(-1.0 + eps)), ("SGS_HI", t(42.0 * eps)),
            ("IB_P_LO", t(1e-6)), ("IB_Q_LO", 1 - t(1e-6)),
            ("IB_P_HI", t(1 - 1e-6)), ("IB_Q_HI", 1 - t(1 - 1e-6)),
            ("CB_P_LO", t(1e-6)), ("CB_Q_LO", 1 - t(1e-6)),
            ("CB_P_HI", 1 - t(1e-6)), ("CB_Q_HI", 1 - (1 - t(1e-6)))):
        assert torch.equal(at[name], want), name
    # float64's are not float32's rounded up
    if dtype == torch.float64:
        assert at["ONE_M_EPS"].item() > float(np.float32(1 - 2**-23))
        assert at["IB_Q_HI"].item() != float(np.float32(1) - np.float32(
            1 - 1e-6))


def test_kernel_params_slope_laws():
    names = TK.PARAM_NAMES
    power = TK.kernel_params_p3(_p3(), TPS_T, dtype=torch.float64)
    const = TK.kernel_params_p3(_p3(slope_law="constant"), TPS_T,
                                dtype=torch.float64)
    slope = _p3().ice.scheme.slope
    assert power[names.index("SLOPE_A")].item() == slope.a
    assert power[names.index("MU_MAX")].item() == slope.mu_max
    assert const[names.index("SLOPE_MU")].item() == \
        _p3(slope_law="constant").ice.scheme.slope.mu
    assert const[names.index("SLOPE_A")].item() == 0.0


def test_kernel_params_take_overrides():
    mp = _p3(quadrature_order=8)
    ice = dataclasses.replace(mp.ice, scheme=dataclasses.replace(
        mp.ice.scheme, tau_wet=50.0), rain_pdf=dataclasses.replace(
            mp.ice.rain_pdf, xr_max=4e-6))
    p = TK.kernel_params_p3(dataclasses.replace(mp, ice=ice), TPS_T)
    names = TK.PARAM_NAMES
    assert p[names.index("INV_TAU_WET")].item() == float(np.float32(1 / 50))
    assert p[names.index("IR_XR_MAX")].item() == float(np.float32(4e-6))
    # the warm rain's own rain PSD is untouched
    assert p[names.index("XR_MAX")].item() == float(np.float32(5e-6))


def test_cuda_source_reads_exactly_the_parameter_list():
    src = (_build.CSRC_DIR / "column_p3.cu").read_text()
    shared = (_build.CSRC_DIR / "warm2m.cuh").read_text()
    used = set(re.findall(r"PVO?\((\w+)\)", src + shared)) - {"name"}
    # the ice rain PSD and ice Chen blocks are read through the shared code
    # at an offset from the 2M blocks they mirror
    offset_read = set(TK.ICE_RAIN_PDF_NAMES) | set(TK.ICE_CHEN_NAMES)
    assert used == set(TK.PARAM_NAMES) - offset_read
    assert len(set(TK.PARAM_NAMES)) == len(TK.PARAM_NAMES)
    for block, mirror in ((TK.ICE_RAIN_PDF_NAMES, TK._RAIN_PDF_BLOCK),
                          (TK.ICE_CHEN_NAMES, TK._CHEN_BLOCK)):
        start, ref = TK.PARAM_NAMES.index(block[0]), \
            TK.PARAM_NAMES.index(mirror[0])
        assert TK.PARAM_NAMES[start:start + len(block)] == block
        assert TK.PARAM_NAMES[ref:ref + len(mirror)] == mirror
    local = set(re.findall(r'#include "([^"]+)"', src))
    assert local == {"column_p3_params.h", "warm2m.cuh"}


# ---------------------------------------------------------------------------
# the launch plan of K5's three kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", SCOPE_ORDERS)
@pytest.mark.parametrize("ncol,nlev,block_cols", [
    (16384, 128, 128), (640, 16, 64), (4096, 64, 256), (1000, 40, 8),
    (1000, 40, 40), (96, 256, 32), (7, 5, 7), (3, 1, 3), (4096, 512, 128),
    (6, 300, 3)])
def test_launch_plan_covers_every_cell(ncol, nlev, order, block_cols):
    plan = TK.launch_plan(ncol, nlev, order, block_cols)
    ncells = ncol * nlev
    assert plan.scratch_shape == (len(TK.SCRATCH_FIELDS), ncells)
    # K5a: a thread per cell
    assert (plan.solve_grid - 1) * TK.SOLVE_THREADS < ncells \
        <= plan.solve_grid * TK.SOLVE_THREADS
    # K5b: a lane per ice node (4 segments x order) when they divide a
    # warp, else a warp walking the nodes in chunks, the last one ragged
    lanes = plan.lanes_per_cell
    assert lanes == (4 * order if 32 % (4 * order) == 0 else 32)
    assert 32 % lanes == 0
    for dtype in (torch.float32, torch.float64):
        per, chunks = TK.node_chunks(order, dtype)
        assert per % lanes == 0 and chunks * per >= 4 * order \
            > (chunks - 1) * per
        # every pass holds a node: fewer lanes than one pass of dead slots
        passes = TK.node_passes(order, dtype)
        assert 0 <= passes * lanes - 4 * order < lanes
    assert plan.node_passes == TK.node_passes(order)
    assert plan.cells_per_block * lanes == TK.NODE_THREADS
    assert (plan.nodes_grid - 1) * plan.cells_per_block < ncells \
        <= plan.nodes_grid * plan.cells_per_block
    # K5c: blocks of whole columns tiling block_cols, within a block's
    # threads, and as many columns as fit; each column in chunks of at
    # most a block's threads of levels
    cols, levels = plan.epilogue_cols, plan.epilogue_levels
    assert levels == min(nlev, TK.EPILOGUE_THREADS)
    assert -(-nlev // levels) * levels >= nlev
    assert block_cols % cols == 0 and plan.epilogue_grid * cols == ncol
    assert plan.epilogue_block == cols * levels <= TK.EPILOGUE_THREADS
    fit = TK.EPILOGUE_THREADS // levels
    assert all(block_cols % d for d in range(cols + 1, min(block_cols, fit)
                                             + 1))


@pytest.mark.parametrize("dtype,order,lanes,per,chunks,passes,masked", [
    ("float32", 1, 4, 4, 1, 1, 0), ("float32", 2, 8, 8, 1, 1, 0),
    ("float32", 4, 16, 16, 1, 1, 0), ("float32", 8, 32, 32, 1, 1, 0),
    ("float32", 16, 32, 64, 1, 2, 0), ("float32", 5, 32, 32, 1, 1, 12),
    ("float32", 25, 32, 64, 2, 4, 28), ("float32", 40, 32, 64, 3, 5, 0),
    ("float32", 100, 32, 64, 7, 13, 16), ("float32", 3, 32, 32, 1, 1, 20),
    ("float32", 24, 32, 64, 2, 3, 0), ("float32", 12, 32, 64, 1, 2, 16),
    ("float32", 160, 32, 64, 10, 20, 0),
    ("float64", 4, 16, 16, 1, 1, 0), ("float64", 16, 32, 32, 2, 2, 0),
    ("float64", 5, 32, 32, 1, 1, 12), ("float64", 40, 32, 32, 5, 5, 0),
    ("float64", 100, 32, 32, 13, 13, 16)])
def test_launch_plan_ragged_node_chunks(dtype, order, lanes, per, chunks,
                                        passes, masked):
    """K5b's lanes per cell, its chunks of ice nodes (two nodes a lane at
    float32, one at float64) and its lane passes a cell: the last chunk
    runs only the passes that hold a node, and in those its lanes past the
    cell's 4N nodes are masked (``masked``: the lane-node evaluations a
    cell that nothing sums). The library's own numbers are checked against
    these at load."""
    dt = getattr(torch, dtype)
    assert TK.lanes_per_cell(order) == lanes
    assert TK.node_chunks(order, dt) == (per, chunks)
    assert TK.node_passes(order, dt) == passes
    assert passes * lanes - 4 * order == masked
    plan = TK.launch_plan(8, 4, order, 8, dt)
    assert (plan.ice_nodes, plan.node_passes) == (4 * order, passes)


def test_launch_plan_fills_the_card_at_the_p3_size():
    # 132 SMs: K5c no longer runs 128 blocks of 128 columns
    plan = TK.launch_plan(16384, 128, 16, 128)
    assert plan.epilogue_grid == 8192 and plan.epilogue_block == 256
    assert plan.nodes_grid == 16384 * 128 // 4
    assert plan.solve_grid == 16384


@pytest.mark.parametrize("ncol,nlev,order,block_cols,error,match", [
    (100, 16, 16, 48, ValueError, "not a multiple"),
    (100, 16, 16, 0, ValueError, "block_cols"),
    (8, 0, 16, 8, ValueError, "nlev >= 1"),
    (8, 16, 0, 8, ValueError, "order >= 1"),
])
def test_launch_plan_rejects(ncol, nlev, order, block_cols, error, match):
    with pytest.raises(error, match=match):
        TK.launch_plan(ncol, nlev, order, block_cols)


def test_scratch_record_matches_the_source():
    src = (_build.CSRC_DIR / "column_p3.cu").read_text()
    body = re.search(r"enum Scratch \{(.*?)kScratch", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert len(names) == len(TK.SCRATCH_FIELDS)
    for name, field in zip(names, TK.SCRATCH_FIELDS):
        assert name.removeprefix("S_").lower() == field.lower(), (name, field)
    for const, value in (("kSolveThreads", TK.SOLVE_THREADS),
                         ("kNodeThreads", TK.NODE_THREADS),
                         ("kEpiThreads", TK.EPILOGUE_THREADS)):
        assert re.search(rf"\b{const} = {value}\b", src), const


@pytest.mark.parametrize("order", SCOPE_ORDERS)
def test_loglambda_wrapper_takes_the_plain_solve_on_cpu(order):
    mp = _p3(quadrature_order=order)
    st = _torch_state(_arrays(), torch.float32)
    before = trace.counter("launches.launch_solve")
    ll = TK.loglambda_p3_fused(st, mp, TPS_T)
    assert torch.equal(ll, TK.loglambda_p3_plain(st, mp))
    _, ll_step = TC.step_column_p3(st, mp, TPS_T, DT, DZ)
    assert torch.equal(ll, ll_step)
    guess = torch.where(torch.isfinite(ll), ll + 0.3, ll)
    assert torch.equal(TK.loglambda_p3_fused(st, mp, TPS_T, guess),
                       TK.loglambda_p3_plain(st, mp, guess))
    assert trace.counter("launches.launch_solve") == before
