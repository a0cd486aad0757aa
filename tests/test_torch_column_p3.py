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
    before = TK.step_column_p3_fused.launches
    out, ll = model(st)
    ref, ll_ref = TC.step_column_p3(st, MP_T, TPS_T, DT, DZ)
    for x, y in zip(out + (ll,), ref + (ll_ref,)):
        assert torch.equal(x, y)
    out2, ll2 = model(out, ll)
    ref2, ll_ref2 = TC.step_column_p3(ref, MP_T, TPS_T, DT, DZ, ll_ref)
    for x, y in zip(out2 + (ll2,), ref2 + (ll_ref2,)):
        assert torch.equal(x, y)
    # the CPU path launches nothing
    assert TK.step_column_p3_fused.launches == before


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

def _p3(**kw):
    return TP.microphysics_2m_params(with_ice=True, **kw)


@pytest.mark.parametrize("mp,nlev,dtype,match", [
    (TP.microphysics_2m_params(), 16, torch.float32, "mp.ice"),
    (_p3(), 16, torch.float64, "float32"),
    (_p3(), TK.MAX_NLEV + 1, torch.float32, "nlev"),
    (_p3(quadrature_order=32), 16, torch.float32, "quadrature orders"),
    (_p3(slope_law="constant"), 16, torch.float32, "SlopePowerLaw"),
    (_p3(aspect_ratio="NoAspectRatio"), 16, torch.float32, "aspect_ratio"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, nlev, dtype, match):
    with pytest.raises(NotImplementedError, match=match):
        TK._check_supported(mp, nlev, dtype)


@pytest.mark.parametrize("order", TK.ORDERS)
@pytest.mark.parametrize("options", [
    {}, dict(is_limited=False, rain_velocity="chen2022")])
def test_cuda_path_accepts_its_scope(order, options):
    TK._check_supported(_p3(quadrature_order=order, **options), TK.MAX_NLEV,
                        torch.float32)


@pytest.mark.parametrize("order", TK.ORDERS)
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

@pytest.mark.parametrize("order", TK.ORDERS)
@pytest.mark.parametrize("ncol,nlev,block_cols", [
    (16384, 128, 128), (640, 16, 64), (4096, 64, 256), (1000, 40, 8),
    (1000, 40, 40), (96, 256, 32), (7, 5, 7), (3, 1, 3)])
def test_launch_plan_covers_every_cell(ncol, nlev, order, block_cols):
    plan = TK.launch_plan(ncol, nlev, order, block_cols)
    ncells = ncol * nlev
    assert plan.scratch_shape == (len(TK.SCRATCH_FIELDS), ncells)
    # K5a: a thread per cell
    assert (plan.solve_grid - 1) * TK.SOLVE_THREADS < ncells \
        <= plan.solve_grid * TK.SOLVE_THREADS
    # K5b: a lane per ice node (4 segments x order), at most a warp a cell
    assert plan.lanes_per_cell == min(32, 4 * order)
    assert 32 % plan.lanes_per_cell == 0
    assert plan.cells_per_block * plan.lanes_per_cell == TK.NODE_THREADS
    assert (plan.nodes_grid - 1) * plan.cells_per_block < ncells \
        <= plan.nodes_grid * plan.cells_per_block
    # K5c: blocks of whole columns tiling block_cols, within a block's
    # threads, and as many columns as fit
    cols = plan.epilogue_cols
    assert block_cols % cols == 0 and plan.epilogue_grid * cols == ncol
    assert plan.epilogue_block == cols * nlev <= TK.EPILOGUE_THREADS
    fit = TK.EPILOGUE_THREADS // nlev
    assert all(block_cols % d for d in range(cols + 1, min(block_cols, fit)
                                             + 1))


def test_launch_plan_fills_the_card_at_the_p3_size():
    # 132 SMs: K5c no longer runs 128 blocks of 128 columns
    plan = TK.launch_plan(16384, 128, 16, 128)
    assert plan.epilogue_grid == 8192 and plan.epilogue_block == 256
    assert plan.nodes_grid == 16384 * 128 // 4
    assert plan.solve_grid == 16384


@pytest.mark.parametrize("ncol,nlev,order,block_cols,error,match", [
    (100, 16, 16, 48, ValueError, "not a multiple"),
    (100, 16, 16, 0, ValueError, "block_cols"),
    (8, TK.MAX_NLEV + 1, 16, 8, NotImplementedError, "nlev"),
    (8, 16, 32, 8, NotImplementedError, "quadrature orders"),
    (8, 16, 6, 8, NotImplementedError, "quadrature orders"),
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


@pytest.mark.parametrize("order", TK.ORDERS)
def test_loglambda_wrapper_takes_the_plain_solve_on_cpu(order):
    mp = _p3(quadrature_order=order)
    st = _torch_state(_arrays(), torch.float32)
    before = TK.launch_solve.launches
    ll = TK.loglambda_p3_fused(st, mp, TPS_T)
    assert torch.equal(ll, TK.loglambda_p3_plain(st, mp))
    _, ll_step = TC.step_column_p3(st, mp, TPS_T, DT, DZ)
    assert torch.equal(ll, ll_step)
    guess = torch.where(torch.isfinite(ll), ll + 0.3, ll)
    assert torch.equal(TK.loglambda_p3_fused(st, mp, TPS_T, guess),
                       TK.loglambda_p3_plain(st, mp, guess))
    assert TK.launch_solve.launches == before
