"""The 1M column step of the port against the JAX package, and the module
that holds the fused CUDA kernel (kernels/column1m.py).

On the CPU the kernel wrappers take their plain PyTorch version; the
kernel itself is compared with that plain version on the card by
chip_smoke.py. Tolerances:

* float64, eager step vs JAX step, and 5 steps of the slice as a whole:
  rtol 1e-9 with an absolute floor of 1e-12 of the largest value (torch
  and XLA:CPU exp/log/pow differ by a few ULP);
* float32, the wrappers vs the Pallas kernels in interpret mode: rtol
  2e-5, atol 2e-9, the contract tests/test_kernels.py holds the Pallas
  kernels to.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu.parameters as JP
import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu.kernels import column1m as JK
from cloudmicrophysics_tpu.models import column as JC
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.kernels import column1m as TK
from cloudmicrophysics_tpu_torch.models import column as TC

MP_J = JP.microphysics_1m_params()
MP_T = TP.from_tree(TP.Microphysics1MParams, dataclasses.asdict(MP_J))
TPS_J, TPS_T = JP.ThermodynamicsParameters(), TP.ThermodynamicsParameters()
TV_J, TV_T = JP.terminal_velocity_params(), TP.terminal_velocity_params()
DT, DZ = 1.0, 100.0
F64_RTOL, F64_ATOL_REL = 1e-9, 1e-12
F32_RTOL, F32_ATOL = 2e-5, 2e-9


def _arrays(ncol, nlev, seed=7):
    """The state of tests/test_kernels.py:24-37, in numpy float64."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    return dict(
        rho=np.linspace(1.2, 0.4, nlev)[None, :] * ones,
        T=np.linspace(300.0, 230.0, nlev)[None, :] * ones,
        q_tot=1e-2 * rng.random(shape), q_lcl=1e-3 * rng.random(shape),
        q_icl=5e-4 * rng.random(shape), q_rai=5e-4 * rng.random(shape),
        q_sno=5e-4 * rng.random(shape))


def _jax_state(a, dtype):
    return JC.ColumnState(*(jnp.asarray(a[k], dtype)
                            for k in JC.ColumnState._fields))


def _torch_state(a, dtype):
    return TP.column_state_from_numpy(a, dtype=dtype)


def _assert_f64(out, ref, what):
    for name, a, b in zip(ref._fields, out, ref):
        b = np.asarray(b)
        atol = F64_ATOL_REL * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a.numpy(), b, rtol=F64_RTOL, atol=atol,
                                   err_msg=f"{what}: {name}")


def _assert_f32(out, ref, what):
    for name, a, b in zip(ref._fields, out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# eager step vs the JAX step, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,nsub,sediment_cloud", [
    ("instantaneous", 1, True), ("instantaneous", 1, False),
    ("linearized_average", 2, True)])
def test_step_column_1m_matches_jax_f64(mode, nsub, sediment_cloud):
    a = _arrays(32, 16)
    ref = JC.step_column_1m(_jax_state(a, jnp.float64), MP_J, TPS_J, TV_J,
                            DT, DZ, mode=mode, nsub=nsub,
                            sediment_cloud=sediment_cloud)
    out = TC.step_column_1m(_torch_state(a, torch.float64), MP_T, TPS_T, TV_T,
                            DT, DZ, mode=mode, nsub=nsub,
                            sediment_cloud=sediment_cloud)
    _assert_f64(out, ref, f"step_column_1m {mode}")


def test_sedimentation_and_surface_precip_match_jax():
    a = _arrays(16, 8)
    rng = np.random.default_rng(1)
    w = rng.uniform(0.0, 5.0, (16, 8))
    ref = JC.sedimentation_tendency(jnp.asarray(a["rho"]),
                                    jnp.asarray(a["q_rai"]), jnp.asarray(w),
                                    DZ)
    out = TC.sedimentation_tendency(torch.as_tensor(a["rho"]),
                                    torch.as_tensor(a["q_rai"]),
                                    torch.as_tensor(w), DZ)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
    ref = JC.surface_precip_rate(_jax_state(a, jnp.float64), MP_J, TV_J)
    out = TC.surface_precip_rate(_torch_state(a, torch.float64), MP_T, TV_T)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F64_RTOL)


# ---------------------------------------------------------------------------
# the kernel wrappers (plain path on CPU tensors) vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_cols", [16, 64])
def test_fused_matches_pallas_f32(block_cols):
    a = _arrays(64, 16)
    ref = JK.step_column_1m_pallas(_jax_state(a, jnp.float32), MP_J, TPS_J,
                                   TV_J, DT, DZ, block_cols=16,
                                   interpret=True)
    out = TK.step_column_1m_fused(_torch_state(a, torch.float32), MP_T,
                                  TPS_T, TV_T, DT, DZ, block_cols=block_cols)
    assert isinstance(out, TC.ColumnState)
    _assert_f32(out, ref, "step_column_1m_fused")


def test_fused_packed_matches_pallas_f32():
    a = _arrays(16, 8)
    ref = JK.unpack_state(JK.step_column_1m_pallas_packed(
        JK.pack_state(_jax_state(a, jnp.float32)), MP_J, TPS_J, TV_J, DT, DZ,
        block_cols=8, interpret=True))
    packed = TK.pack_state(_torch_state(a, torch.float32))
    out = TK.step_column_1m_fused_packed(packed, MP_T, TPS_T, TV_T, DT, DZ,
                                         block_cols=8)
    assert out.shape == (7, 16, 8) and out.dtype == torch.float32
    _assert_f32(TK.unpack_state(out), ref, "step_column_1m_fused_packed")


@pytest.mark.parametrize("packed", [False, True])
def test_q_tot_affine_matches_pallas_f32(packed):
    a = _arrays(16, 8)
    affine = (1.01, 2e-9)
    js, ts = _jax_state(a, jnp.float32), _torch_state(a, torch.float32)
    if packed:
        ref = JK.unpack_state(JK.step_column_1m_pallas_packed(
            JK.pack_state(js), MP_J, TPS_J, TV_J, DT, DZ, block_cols=8,
            interpret=True, q_tot_affine=affine))
        out = TK.unpack_state(TK.step_column_1m_fused_packed(
            TK.pack_state(ts), MP_T, TPS_T, TV_T, DT, DZ, block_cols=8,
            q_tot_affine=affine))
    else:
        ref = JK.step_column_1m_pallas(js, MP_J, TPS_J, TV_J, DT, DZ,
                                       block_cols=8, interpret=True,
                                       q_tot_affine=affine)
        out = TK.step_column_1m_fused(ts, MP_T, TPS_T, TV_T, DT, DZ,
                                      block_cols=8, q_tot_affine=affine)
    _assert_f32(out, ref, "q_tot_affine")
    # in-kernel affine == scaling q_tot before the call
    pre = TK.step_column_1m_plain(
        ts._replace(q_tot=ts.q_tot * affine[0] + affine[1]), MP_T, TPS_T,
        TV_T, DT, DZ)
    for x, y in zip(out, pre):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("packed", [False, True])
def test_bad_tiling_raises(packed):
    st = _torch_state(_arrays(20, 8), torch.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        if packed:
            TK.step_column_1m_fused_packed(TK.pack_state(st), MP_T, TPS_T,
                                           TV_T, DT, DZ, block_cols=16)
        else:
            TK.step_column_1m_fused(st, MP_T, TPS_T, TV_T, DT, DZ,
                                    block_cols=16)


def test_pack_unpack_round_trip():
    st = _torch_state(_arrays(16, 8), torch.float32)
    packed = TK.pack_state(st)
    assert packed.shape == (7, 16, 8) and packed.is_contiguous()
    for x, y in zip(st, TK.unpack_state(packed)):
        assert torch.equal(x, y)
    ref = JK.pack_state(_jax_state(_arrays(16, 8), jnp.float32))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))


def test_cpu_path_does_not_count_launches():
    st = _torch_state(_arrays(16, 8), torch.float32)
    before = (TK.step_column_1m_fused.launches,
              TK.step_column_1m_fused_packed.launches)
    TK.step_column_1m_fused(st, MP_T, TPS_T, TV_T, DT, DZ, block_cols=8)
    TK.step_column_1m_fused_packed(TK.pack_state(st), MP_T, TPS_T, TV_T, DT,
                                   DZ, block_cols=8)
    assert (TK.step_column_1m_fused.launches,
            TK.step_column_1m_fused_packed.launches) == before


# ---------------------------------------------------------------------------
# what the CUDA path accepts, and the kernel's parameter buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp,mode,nlev,dtype,match", [
    (MP_T, "linearized_average", 16, torch.float32, "instantaneous"),
    (TP.microphysics_1m_params(snow_melt=None), "instantaneous", 16,
     torch.float32, "default"),
    (MP_T, "instantaneous", 16, torch.float64, "float32"),
    (MP_T, "instantaneous", TK.MAX_NLEV + 1, torch.float32, "nlev"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, mode, nlev, dtype, match):
    with pytest.raises(NotImplementedError, match=match):
        TK._check_supported(mp, mode, nlev, dtype)


def test_cuda_path_accepts_float_overrides():
    mp = TP.microphysics_1m_params(
        process_overrides={"Kessler1M": {"tau": 900.0}})
    TK._check_supported(mp, "instantaneous", TK.MAX_NLEV, torch.float32)


def test_kernel_params_buffer():
    p = TK.kernel_params(MP_T, TPS_T, TV_T)
    assert p.dtype == torch.float32 and p.shape == (len(TK.PARAM_NAMES),)
    assert bool(torch.isfinite(p).all())
    values = TK._param_values(MP_T, TPS_T, TV_T)
    for i, name in enumerate(TK.PARAM_NAMES):
        assert p[i].item() == float(np.float32(values[name])), name
    # a float override reaches the buffer
    mp = TP.microphysics_1m_params(
        process_overrides={"RainSnowAccretion": {"e": 0.7}})
    q = TK.kernel_params(mp, TPS_T, TV_T)
    assert q[TK.PARAM_NAMES.index("E_RS")].item() == float(np.float32(0.7))


def test_cuda_source_reads_exactly_the_parameter_list():
    # the header the build generates is the only link between the list and
    # csrc/column1m.cu: every name the source reads must be in it
    src = (_build.CSRC_DIR / "column1m.cu").read_text()
    used = set(re.findall(r"PV\((\w+)\)", src)) - {"name"}
    assert used == set(TK.PARAM_NAMES)
    header = _build.index_header(TK.PARAM_NAMES, "G")
    for i, name in enumerate(TK.PARAM_NAMES):
        assert f"#define P_{name} {i}\n" in header
    assert f"#define N_PARAMS {len(TK.PARAM_NAMES)}" in header


# ---------------------------------------------------------------------------
# the slice as a whole: Column1MStep for 5 steps vs 5 JAX steps, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_column1m_step_five_steps_matches_jax(packed):
    a = _arrays(64, 16)
    js = _jax_state(a, jnp.float64)
    for _ in range(5):
        js = JC.step_column_1m(js, MP_J, TPS_J, TV_J, DT, DZ)
    model = TC.Column1MStep(MP_T, TPS_T, TV_T, DT, DZ)
    st = _torch_state(a, torch.float64)
    x = TK.pack_state(st) if packed else st
    for _ in range(5):
        x = model(x)
    out = TK.unpack_state(x) if packed else x
    _assert_f64(out, js, "Column1MStep x5")
    for v in out:
        assert bool(torch.isfinite(v).all())
