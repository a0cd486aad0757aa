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
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.kernels import column2m as JK
from cloudmicrophysics_tpu.models import column as JC
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
    before = (TK.step_column_2m_fused.launches,
              TK.step_column_2m_fused_packed.launches)
    TK.step_column_2m_fused(st, MP_T, TPS_T, DT, DZ, block_cols=8)
    TK.step_column_2m_fused_packed(TK.pack_state_2m(st), MP_T, TPS_T, DT, DZ,
                                   block_cols=8)
    TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")(st)
    assert (TK.step_column_2m_fused.launches,
            TK.step_column_2m_fused_packed.launches) == before


# ---------------------------------------------------------------------------
# what the CUDA path accepts, and the kernel's parameter buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp,nlev,dtype,match", [
    (dataclasses.replace(MP_T, ice=object()), 16, torch.float32, "P3 ice"),
    (dataclasses.replace(MP_T, warm_rain=dataclasses.replace(
        MP_T.warm_rain, terminal_velocity=TP.StokesRegimeVelType())),
     16, torch.float32, "rain velocities"),
    (MP_T, 16, torch.float64, "float32"),
    (MP_T, TK.MAX_NLEV + 1, torch.float32, "nlev"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, nlev, dtype, match):
    with pytest.raises(NotImplementedError, match=match):
        TK._check_supported(mp, nlev, dtype)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", ["device", "float64", "nlev", "P3 ice"])
def test_wrappers_raise_and_do_not_fall_back(monkeypatch, packed, case):
    # a tensor anywhere but on the CPU launches the kernel or raises: the
    # plain version and the library are never reached for what the kernel
    # lacks (meta tensors stand in for a card's; "device": no kernel there,
    # the others: a CUDA device as _check_cuda would report it)
    def refuse(*args, **kwargs):
        raise AssertionError("fell back or reached the kernel library")

    for name in ("step_column_2m_plain", "step_column_2m_packed_plain",
                 "_library"):
        monkeypatch.setattr(TK, name, refuse)
    if case != "device":
        monkeypatch.setattr(TK, "_check_cuda",
                            lambda *a: torch.device("cuda", 0))
    nlev = TK.MAX_NLEV + 1 if case == "nlev" else 8
    dtype = torch.float64 if case == "float64" else torch.float32
    mp = dataclasses.replace(MP_T, ice=object()) if case == "P3 ice" else MP_T
    st = TC.ColumnState2M(*(torch.empty((16, nlev), dtype=dtype,
                                        device="meta") for _ in range(7)))
    match = "device type 'meta'" if case == "device" else case
    with pytest.raises(NotImplementedError, match=match):
        if packed:
            TK.step_column_2m_fused_packed(TK.pack_state_2m(st), mp, TPS_T,
                                           DT, DZ, block_cols=8)
        else:
            TK.step_column_2m_fused(st, mp, TPS_T, DT, DZ, block_cols=8)


@pytest.mark.parametrize("options", OPTIONS)
def test_cuda_path_accepts_both_options(options):
    TK._check_supported(_mps(**options)[1], TK.MAX_NLEV, torch.float32)
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
    assert "#define PV(name) __ldg(P + P_##name)" in default
    assert "#define PVO(name) __ldg(P + P_##name + OFF)" in default


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


def test_host_params_is_the_block_the_kernel_is_built_for():
    p = TK.host_params(None, MP_T, TPS_T)
    assert p.device.type == "cpu" and p.dtype == torch.float32
    assert p.shape == (len(TK.PARAM_NAMES),) and p.is_contiguous()
    values = TK._param_values(MP_T, TPS_T)
    assert p.tolist() == [float(np.float32(values[n]))
                          for n in TK.PARAM_NAMES]
    variant = TK._variant(MP_T)
    assert TK.header(p, variant) == TK.header(
        TK.kernel_params_2m(MP_T, TPS_T), variant)
    model = TC.Column2MStep(MP_T, TPS_T, DT, DZ, device="cpu")
    assert torch.equal(model.params, p)
    assert model.to("cpu").params.device.type == "cpu"


def test_host_params_makes_no_copy(monkeypatch):
    # choosing a CUDA-bound call's library reads the host block in place:
    # no transfer, no copy, no synchronising read of a device value
    block = TK.kernel_params_2m(MP_T, TPS_T)

    def refuse(*args, **kwargs):
        raise AssertionError("a copy or transfer of the parameter block")

    for name in ("to", "cpu", "cuda", "clone", "copy_", "item",
                 "contiguous"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    assert TK.host_params(block, MP_T, TPS_T) is block
    assert "#define PC_EM" in TK.header(block, TK._variant(MP_T))
    monkeypatch.undo()
    # a block anywhere but on the host is refused, not copied back
    with pytest.raises(ValueError, match="host parameter block"):
        TK.host_params(torch.empty(len(TK.PARAM_NAMES), device="meta"),
                       MP_T, TPS_T)
    with pytest.raises(ValueError, match="host parameter block"):
        TK.host_params(block.double(), MP_T, TPS_T)


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
