"""The 2M warm-rain column step of the port against the JAX package, and
the module that holds the fused CUDA kernel (kernels/column2m.py).

On the CPU the kernel wrappers take their plain PyTorch version; the
kernel itself is compared with that plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py. Tolerances:

* float64, eager step vs JAX step, and 5 steps of the slice as a whole:
  rtol 1e-9 with an absolute floor of 1e-12 of the largest value (torch
  and XLA:CPU exp/log/pow differ by a few ULP);
* float32, the wrappers vs the Pallas kernels in interpret mode: rtol
  2e-5 with atol 2e-9 for temperature and contents and atol 1e-8 for the
  number fields (~1e8, so rtol decides), as tests/test_kernels.py:132
  holds the Pallas kernels.
"""

import dataclasses
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.kernels import column2m as JK
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.kernels import column2m as TK
from cloudmicrophysics_tpu_torch.models import column as TC
from test_torch_column1m import _parameter_divisions

TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
DT, DZ = 1.0, 100.0
F64_RTOL, F64_ATOL_REL = 1e-9, 1e-12
F32_RTOL, F32_ATOL, F32_ATOL_N = 2e-5, 2e-9, 1e-8
OPTIONS = [dict(is_limited=lim, rain_velocity=vel)
           for lim in (True, False) for vel in ("sb2006", "chen2022")]


def _mps(**options):
    mp_j = JP.microphysics_2m_params(**options)
    return mp_j, TP.from_tree(TP.Microphysics2MParams,
                              dataclasses.asdict(mp_j))


MP_J, MP_T = _mps()


def _arrays(ncol, nlev, seed=7):
    """rho and T profiles over the levels, random contents and numbers."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    return dict(
        rho=np.linspace(1.2, 0.4, nlev)[None, :] * ones,
        T=np.linspace(300.0, 220.0, nlev)[None, :] * ones,
        q_tot=1e-2 * rng.random(shape), q_lcl=1e-3 * rng.random(shape),
        n_lcl=1e8 * rng.random(shape), q_rai=5e-4 * rng.random(shape),
        n_rai=1e6 * rng.random(shape))


def _jax_state(a, dtype):
    return JC.ColumnState2M(*(jnp.asarray(a[k], dtype)
                              for k in JC.ColumnState2M._fields))


def _torch_state(a, dtype):
    return TP.column_state_2m_from_numpy(a, device="cpu", dtype=dtype)


def _assert_f64(out, ref, what):
    for name, a, b in zip(ref._fields, out, ref):
        b = np.asarray(b)
        atol = F64_ATOL_REL * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a.numpy(), b, rtol=F64_RTOL, atol=atol,
                                   err_msg=f"{what}: {name}")


def _assert_f32(out, ref, what):
    for name, a, b in zip(ref._fields, out, ref):
        atol = F32_ATOL_N if name.startswith("n_") else F32_ATOL
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL,
                                   atol=atol, err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# eager step vs the JAX step, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("options", OPTIONS)
def test_step_column_2m_matches_jax_f64(options):
    mp_j, mp_t = _mps(**options)
    a = _arrays(32, 16)
    ref = JC.step_column_2m(_jax_state(a, jnp.float64), mp_j, TPS_J, DT, DZ)
    out = TC.step_column_2m(_torch_state(a, torch.float64), mp_t, TPS_T, DT,
                            DZ)
    assert isinstance(out, TC.ColumnState2M)
    _assert_f64(out, ref, f"step_column_2m {options}")


def test_step_column_2m_impls():
    st = _torch_state(_arrays(24, 8), torch.float64)
    eager = TC.step_column_2m(st, MP_T, TPS_T, DT, DZ)
    # block_cols 128 is halved to 8, which divides 24; CPU -> plain version
    fused = TC.step_column_2m(st, MP_T, TPS_T, DT, DZ, impl="fused")
    for x, y in zip(eager, fused):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown impl"):
        TC.step_column_2m(st, MP_T, TPS_T, DT, DZ, impl="xla")


@pytest.mark.parametrize("case", ["float32", "float64", "halving",
                                  "transposed", "mixed"])
def test_fused_fields_path_is_the_packed_path(case):
    """``step_column_2m(impl="fused")`` steps the seven fields where they
    lie, and gives what stacking them and stepping the packed state gives,
    bit for bit: at float32 and float64, at an ``ncol`` (24) that halves
    ``block_cols`` from 128 to 8, on non-contiguous fields (a transposed
    view's) and on float32 fields mixed with float64 ones (promoted as
    ``torch.stack`` promotes them)."""
    ncol = 24 if case == "halving" else 32
    dtype = torch.float64 if case == "float64" else torch.float32
    st = _torch_state(_arrays(ncol, 8), dtype)
    if case == "transposed":
        st = TC.ColumnState2M(*(t.T.contiguous().T for t in st))
        assert not any(t.is_contiguous() for t in st)
    if case == "mixed":
        st = st._replace(q_tot=st.q_tot.double(), n_rai=st.n_rai.double())
        dtype = torch.float64
    ref = TK.unpack_state_2m(TK.step_column_2m_fused_packed(
        TK.pack_state_2m(st), MP_T, TPS_T, DT, DZ, block_cols=ncol & -ncol))
    out = TC.step_column_2m(st, MP_T, TPS_T, DT, DZ, impl="fused")
    assert isinstance(out, TC.ColumnState2M)
    for name, a, b in zip(TC.ColumnState2M._fields, out, ref):
        assert a.dtype == b.dtype == dtype, name
        assert a.is_contiguous() and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the kernel wrappers (plain path on CPU tensors) vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("options", [OPTIONS[0], OPTIONS[3]])
def test_fused_matches_pallas_f32(options):
    mp_j, mp_t = _mps(**options)
    a = _arrays(32, 8)
    ref = JK.step_column_2m_pallas(_jax_state(a, jnp.float32), mp_j, TPS_J,
                                   DT, DZ, block_cols=8, interpret=True)
    out = TK.step_column_2m_fused(_torch_state(a, torch.float32), mp_t,
                                  TPS_T, DT, DZ, block_cols=16)
    assert isinstance(out, TC.ColumnState2M)
    _assert_f32(out, ref, "step_column_2m_fused")


@pytest.mark.parametrize("affine", [None, (1.01, 2e-9)])
def test_fused_packed_matches_pallas_f32(affine):
    a = _arrays(32, 8)
    ref = JK.unpack_state_2m(JK.step_column_2m_pallas_packed(
        JK.pack_state_2m(_jax_state(a, jnp.float32)), MP_J, TPS_J, DT, DZ,
        block_cols=8, interpret=True, q_tot_affine=affine))
    ts = _torch_state(a, torch.float32)
    out = TK.step_column_2m_fused_packed(TK.pack_state_2m(ts), MP_T, TPS_T,
                                         DT, DZ, block_cols=8,
                                         q_tot_affine=affine)
    assert out.shape == (7, 32, 8) and out.dtype == torch.float32
    _assert_f32(TK.unpack_state_2m(out), ref, "step_column_2m_fused_packed")
    if affine is not None:
        # in-kernel affine == scaling q_tot before the call
        pre = TK.step_column_2m_plain(
            ts._replace(q_tot=ts.q_tot * affine[0] + affine[1]), MP_T, TPS_T,
            DT, DZ)
        for x, y in zip(TK.unpack_state_2m(out), pre):
            assert torch.equal(x, y)


def test_fused_matches_pallas_on_the_bench_state():
    # the uniform state of tests/test_kernels.py:114 and the TPU bench
    vals = dict(rho=1.1, T=288.0, q_tot=6e-3, q_lcl=1e-3, n_lcl=9e7,
                q_rai=5e-4, n_rai=9e5)
    a = {k: np.full((32, 8), v) for k, v in vals.items()}
    ref = JK.step_column_2m_pallas(_jax_state(a, jnp.float32), MP_J, TPS_J,
                                   DT, DZ, block_cols=8, interpret=True)
    out = TK.step_column_2m_fused(_torch_state(a, torch.float32), MP_T,
                                  TPS_T, DT, DZ, block_cols=8)
    _assert_f32(out, ref, "uniform bench state")


@pytest.mark.parametrize("packed", [False, True])
def test_bad_tiling_raises(packed):
    st = _torch_state(_arrays(20, 8), torch.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        if packed:
            TK.step_column_2m_fused_packed(TK.pack_state_2m(st), MP_T, TPS_T,
                                           DT, DZ, block_cols=16)
        else:
            TK.step_column_2m_fused(st, MP_T, TPS_T, DT, DZ, block_cols=16)


def test_pack_unpack_round_trip():
    a = _arrays(16, 8)
    st = _torch_state(a, torch.float32)
    packed = TK.pack_state_2m(st)
    assert packed.shape == (7, 16, 8) and packed.is_contiguous()
    for x, y in zip(st, TK.unpack_state_2m(packed)):
        assert torch.equal(x, y)
    ref = JK.pack_state_2m(_jax_state(a, jnp.float32))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="7, ncol, nlev"):
        TK.step_column_2m_fused_packed(packed[:6], MP_T, TPS_T, DT, DZ)


def test_cpu_path_does_not_count_launches():
    st = _torch_state(_arrays(16, 8), torch.float32)
    names = ("launches.step_column_2m_fused",
             "launches.step_column_2m_fused_packed")
    before = [trace.counter(n) for n in names]
    TK.step_column_2m_fused(st, MP_T, TPS_T, DT, DZ, block_cols=8)
    TK.step_column_2m_fused_packed(TK.pack_state_2m(st), MP_T, TPS_T, DT, DZ,
                                   block_cols=8)
    TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")(st)
    assert [trace.counter(n) for n in names] == before


# ---------------------------------------------------------------------------
# what the CUDA path accepts, and the kernel's parameter buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp,nlev,dtype,error,match", [
    (dataclasses.replace(MP_T, ice=object()), 16, torch.float32,
     NotImplementedError, "P3 ice"),
    (dataclasses.replace(MP_T, warm_rain=dataclasses.replace(
        MP_T.warm_rain, terminal_velocity=TP.StokesRegimeVelType())),
     16, torch.float32, NotImplementedError, "rain velocities"),
    (MP_T, 16, torch.bfloat16, NotImplementedError, "float32 and float64"),
    (MP_T, 0, torch.float32, ValueError, "nlev"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, nlev, dtype, error,
                                                 match):
    with pytest.raises(error, match=match):
        TK._check_supported(mp, nlev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nlev", [16, 333, 512, 1024])
def test_cuda_path_accepts_float64_and_any_level_count(dtype, nlev):
    for options in OPTIONS:
        TK._check_supported(_mps(**options)[1], nlev, dtype)


@pytest.mark.parametrize("options", OPTIONS)
def test_float64_header_round_trips_exactly(options):
    mp = _mps(**options)[1]
    block = TK.kernel_params_2m(mp, TPS_T, torch.float64)
    header = TK.header(block, TK._variant(mp))
    assert "#define K3_REAL double\n" in header
    literals = re.findall(r"#define PC_\w+ \((\S+)\)", header)
    assert len(literals) == len(TK.PARAM_NAMES)
    assert not any(x.endswith("f") for x in literals)
    assert [float.fromhex(x) for x in literals] == block.tolist()
    # the dtype's thresholds; every other value is the float32 block's,
    # unrounded
    i = TK.PARAM_NAMES.index
    assert block[i("EM")] == torch.finfo(torch.float64).eps
    assert block[i("TINY")] == torch.finfo(torch.float64).tiny
    f32 = TK.kernel_params_2m(mp, TPS_T)
    assert torch.equal(block[i("T_0"):].to(torch.float32), f32[i("T_0"):])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", ["device", "bfloat16", "nlev", "P3 ice"])
def test_wrappers_raise_and_do_not_fall_back(monkeypatch, packed, case):
    # a tensor anywhere but on the CPU launches the kernel or raises: the
    # plain version and the library are never reached for what the kernel
    # lacks (meta tensors stand in for a card's; "device": no kernel there,
    # the others: a CUDA device as _build.check_cuda would report it)
    def refuse(*args, **kwargs):
        raise AssertionError("fell back or reached the kernel library")

    for name in ("step_column_2m_plain", "step_column_2m_packed_plain",
                 "_library"):
        monkeypatch.setattr(TK, name, refuse)
    if case != "device":
        monkeypatch.setattr(_build, "check_cuda",
                            lambda *a: torch.device("cuda", 0))
    nlev = 0 if case == "nlev" else 8     # a layout without levels
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    mp = dataclasses.replace(MP_T, ice=object()) if case == "P3 ice" else MP_T
    st = TC.ColumnState2M(*(torch.empty((16, nlev), dtype=dtype,
                                        device="meta") for _ in range(7)))
    match = "device type 'meta'" if case == "device" else case
    error = ValueError if case == "nlev" else NotImplementedError
    with pytest.raises(error, match=match):
        if packed:
            TK.step_column_2m_fused_packed(TK.pack_state_2m(st), mp, TPS_T,
                                           DT, DZ, block_cols=8)
        else:
            TK.step_column_2m_fused(st, mp, TPS_T, DT, DZ, block_cols=8)


@pytest.mark.parametrize("options", OPTIONS)
def test_cuda_path_accepts_both_options(options):
    TK._check_supported(_mps(**options)[1], 512, torch.float32)
    assert TK._variant(_mps(**options)[1]) == (
        int(options["is_limited"]), int(options["rain_velocity"] == "chen2022"))


def test_kernel_params_buffer():
    p = TK.kernel_params_2m(MP_T, TPS_T)
    assert p.dtype == torch.float32 and p.shape == (len(TK.PARAM_NAMES),)
    assert p.device.type == "cpu"
    assert bool(torch.isfinite(p).all())
    values = TK._param_values(MP_T, TPS_T)
    for i, name in enumerate(TK.PARAM_NAMES):
        assert p[i].item() == float(np.float32(values[name])), name
    # float overrides reach the buffer
    mp = TP.from_tree(TP.Microphysics2MParams, dataclasses.asdict(
        JP.microphysics_2m_params(rain_velocity="chen2022")))
    sb = TP.sb2006(accr={"kcr": 6.0}, numadj={"tau": 50.0})
    mp = dataclasses.replace(mp, warm_rain=dataclasses.replace(
        mp.warm_rain, seifert_beheng=sb))
    q = TK.kernel_params_2m(mp, TPS_T)
    assert q[TK.PARAM_NAMES.index("KCR")].item() == 6.0
    assert q[TK.PARAM_NAMES.index("INV_NUMADJ_TAU")].item() == float(
        np.float32(1 / 50.0))
    assert q[TK.PARAM_NAMES.index("CH_BRHO")].item() == float(
        np.float32(TP.Chen2022VelTypeRain().b_rho))


def _source(name="column2m.cu"):
    """A file of csrc/ without its comments."""
    src = (_build.CSRC_DIR / name).read_text()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def test_cuda_source_reads_exactly_the_parameter_list():
    # the generated header is the only link between the list and
    # csrc/column2m.cu with the warm-rain device code it includes
    # (csrc/warm2m.cuh, shared with the P3 kernel): every name they read
    # must be in it, and column2m.cu reads them through warm2m.cuh's literal
    # accessor, as the header's literals, never from memory
    src, shared = _source(), _source("warm2m.cuh")
    used = set(re.findall(r"PVO?\((\w+)\)", src + shared)) - {"name"}
    assert used == set(TK.PARAM_NAMES)
    includes = re.findall(r'#(include "[^"]+"|define WARM2M_LITERAL_PARAMS)',
                          src)
    assert includes == ['include "column2m_params.h"',
                        "define WARM2M_LITERAL_PARAMS",
                        'include "warm2m.cuh"', 'include "stage_probe.cuh"']
    assert "#define PV(name) (PC_##name)" in shared
    assert re.findall(r"\bPC_\w+", src) == []   # no literal outside PV()
    assert "__ldg" not in src and "__restrict__ P" not in src
    header = TK.header(TK.kernel_params_2m(MP_T, TPS_T), (1, 0))
    names = re.findall(r"#define PC_(\w+) ", header)
    assert tuple(names) == TK.PARAM_NAMES
    assert "#define K3_LIMITED 1\n#define K3_CHEN 0\n" in header
    assert f"#define N_PARAMS {len(TK.PARAM_NAMES)}\n" in header


def test_p3_kernel_keeps_its_parameter_loads():
    # column_p3.cu includes warm2m.cuh without the literal accessor, so the
    # shared code reads the P3 kernel's parameter buffer, as it always has
    src = _source("column_p3.cu")
    assert "WARM2M_LITERAL_PARAMS" not in src
    assert '#include "column_p3_params.h"\n#include "warm2m.cuh"' in src
    shared = _source("warm2m.cuh")
    default = shared[shared.index("#else"):shared.index("#endif")]
    assert "#define PV(name) ::warm2m::ldp(P + P_##name)" in default
    assert "#define PVO(name) ::warm2m::ldp(P + P_##name + OFF)" in default
    # a read-only load as the cells' type: float from a float32 buffer,
    # real.cuh's Dbl from a float64 one
    assert ("__device__ __forceinline__ float ldp(const float* p) { return "
            "__ldg(p); }") in shared
    assert ("__device__ __forceinline__ Dbl ldp(const double* p) { return "
            "Dbl(__ldg(p)); }") in shared


@pytest.mark.parametrize("options", [OPTIONS[0], OPTIONS[3]])
def test_header_holds_each_value_exactly(options):
    mp = _mps(**options)[1]
    block, variant = TK.kernel_params_2m(mp, TPS_T), TK._variant(mp)
    header = TK.header(block, variant)
    literals = re.findall(r"#define PC_\w+ \((\S+)f\)", header)
    assert len(literals) == len(TK.PARAM_NAMES)
    assert [float.fromhex(x) for x in literals] == block.tolist()
    assert (f"#define K3_LIMITED {variant[0]}\n#define K3_CHEN {variant[1]}\n"
            in header)
    # another block or another variant is another header, so another build
    sb = TP.sb2006(accr={"kcr": 6.0})
    other = dataclasses.replace(mp, warm_rain=dataclasses.replace(
        mp.warm_rain, seifert_beheng=sb))
    assert TK.header(TK.kernel_params_2m(other, TPS_T), variant) != header
    assert TK.header(block, (1 - variant[0], variant[1])) != header
    with pytest.raises(ValueError, match=f"{len(TK.PARAM_NAMES)} values"):
        TK.header(block[:10], variant)
    with pytest.raises(ValueError, match="non-finite"):
        TK.header(torch.where(torch.arange(len(block)) == 3,
                              torch.tensor(float("nan")), block), variant)
    with pytest.raises(ValueError, match="two flags"):
        TK.header(block, (2, 0))


@pytest.mark.parametrize("name", ["column2m.cu", "warm2m.cuh"])
def test_cuda_source_divides_by_no_parameter(name):
    # a division by a parameter would round otherwise than the eager step's
    # multiply by its host-folded reciprocal
    assert _parameter_divisions(_source(name)) == []


# ---------------------------------------------------------------------------
# the slice as a whole: Column2MStep for 5 steps vs 5 JAX steps, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_column2m_step_five_steps_matches_jax(packed):
    a = _arrays(64, 16)
    js = _jax_state(a, jnp.float64)
    for _ in range(5):
        js = JC.step_column_2m(js, MP_J, TPS_J, DT, DZ)
    model = TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")
    assert model.params.shape == (len(TK.PARAM_NAMES),)
    st = _torch_state(a, torch.float64)
    x = TK.pack_state_2m(st) if packed else st
    for _ in range(5):
        x = model(x)
    out = TK.unpack_state_2m(x) if packed else x
    _assert_f64(out, js, "Column2MStep x5")
    for v in out:
        assert bool(torch.isfinite(v).all())


def test_column2m_step_affine_needs_the_packed_state():
    st = _torch_state(_arrays(16, 8), torch.float32)
    model = TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        model(st, q_tot_affine=(1.0, 1e-9))
    out = model(TK.pack_state_2m(st), q_tot_affine=(1.01, 2e-9))
    ref = TK.step_column_2m_packed_plain(TK.pack_state_2m(st), MP_T, TPS_T,
                                         DT, DZ, q_tot_affine=(1.01, 2e-9))
    assert torch.equal(out, ref)


def test_column2m_step_module_float64_block():
    # a float64 state steps with the float64 block, built once at its first
    # step; float32 stays the module's params; a dtype no kernel is built
    # for has none
    model = TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")
    block = model.block(torch.float64)
    assert block.dtype == torch.float64 and model.block(torch.float64) is block
    assert torch.equal(block, TK.kernel_params_2m(MP_T, TPS_T, torch.float64))
    assert TK.host_params(block, MP_T, TPS_T, torch.float64) is block
    assert model.block(torch.float32) is model.params
    assert model.block(torch.bfloat16) is None
    a = _arrays(16, 8)
    st = _torch_state(a, torch.float64)
    ref = JC.step_column_2m(_jax_state(a, jnp.float64), MP_J, TPS_J, DT, DZ)
    _assert_f64(model(st), ref, "Column2MStep float64")
    fused = TC.step_column_2m(st, MP_T, TPS_T, DT, DZ, impl="fused")
    for x, y in zip(fused, model(st)):
        assert torch.equal(x, y)


# (ncol, nlev, block_cols, warps): the share of busy lanes, cells / lane
# slots
LANE_PLANS = {
    # the 2m_fields cell: 8 columns of 100 levels a warp, 25 full windows
    "cell": ((1048576, 100, 128, 16), 1.0),
    # whole columns fill whole windows: a level chunk a column, as before
    "nlev 32": ((4096, 32, 16, 16), 1.0),
    "nlev 128": ((819200, 128, 128, 16), 1.0),
    "nlev 512": ((131072, 512, 16, 16), 1.0),
    # fewer columns a block than warps: eight warps idle, a column each
    # for the other eight, two windows of 64 slots for 40 cells
    "8 columns, 16 warps": ((1000, 40, 8, 16), 40 / 64),
    # a window spans 32 columns of one level, or four and a half of seven
    "nlev 1": ((64, 1, 16, 16), 1 / 32),
    "nlev 1 wide": ((4096, 1, 512, 16), 1.0),
    "nlev 7": ((96, 7, 32, 16), 14 / 32),
    # float64's 8 warps: 16 columns a warp in the cell, two in Column2MStep
    "float64 cell": ((1048576, 100, 128, 8), 1.0),
    "float64 block 16": ((512, 100, 16, 8), 200 / 224),
    # uneven ranges: 24 columns over 16 warps, 2 + ... + 2 + 1 + ... + 1
    "uneven": ((48, 33, 24, 16), 24 * 33 / (8 * 96 + 8 * 64)),
}


@pytest.mark.parametrize("case", list(LANE_PLANS))
def test_lane_slots_follow_the_window_plan(case):
    (ncol, nlev, block_cols, warps), busy = LANE_PLANS[case]
    slots = TK.lane_slots(ncol, nlev, block_cols, warps)
    assert ncol * nlev / slots == pytest.approx(busy, rel=1e-15)
    if nlev % 32 == 0:
        # a level chunk a column: the count of the plan before windows
        assert slots == ncol * math.ceil(nlev / 32) * 32
    # no plan steps fewer slots than cells, nor more than a window a warp
    # beyond them
    blocks = math.ceil(ncol / block_cols)
    assert ncol * nlev <= slots < ncol * nlev + 32 * warps * blocks


def test_lane_slots_of_a_ragged_last_block():
    # 40 columns at 16 a block: the last block's 8 columns as 8 warps' one
    assert TK.lane_slots(40, 100, 16, 16) == 2 * 16 * 128 + 8 * 128
