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
from cloudmicrophysics_tpu_torch import trace
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
    return TP.column_state_from_numpy(a, device="cpu", dtype=dtype)


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


# the whole scope of step_column_1m: each option set, both modes, float32
# and float64, more than 256 levels and a level count that is not a
# multiple of 32
ALTERNATIVES = {"cloud_ice_formation": "TemperatureDependent",
                "rain_autoconversion": "PrescribedNd",
                "snow_autoconversion": "WithSupersaturation",
                "snow_deposition_sublimation": "SublimationOnly"}
OPTION_SETS = ([{slot: opt} for slot, opt in ALTERNATIVES.items()]
               + [{slot: None} for slot in TK.OPTION_CODES]
               + [{slot: None for slot in TK.OPTION_CODES},
                  dict(ALTERNATIVES, cloud_ice_melt=None,
                       rain_snow_accretion=None)])


def _option_id(opts):
    if len(opts) == len(TK.OPTION_CODES):
        return "every-slot-None"
    return "+".join(f"{k}={v}" for k, v in opts.items())


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


@pytest.mark.parametrize("nsub,sediment_cloud", [(1, True), (2, False),
                                                  (4, True)])
def test_linearized_average_matches_jax_f64(nsub, sediment_cloud):
    # a host model's large step (10 s) in nsub linearized implicit substeps
    a = _arrays(32, 16, seed=3)
    ref = JC.step_column_1m(_jax_state(a, jnp.float64), MP_J, TPS_J, TV_J,
                            10.0, DZ, mode="linearized_average", nsub=nsub,
                            sediment_cloud=sediment_cloud)
    out = TC.step_column_1m(_torch_state(a, torch.float64), MP_T, TPS_T, TV_T,
                            10.0, DZ, mode="linearized_average", nsub=nsub,
                            sediment_cloud=sediment_cloud)
    _assert_f64(out, ref, f"linearized_average nsub={nsub}")


def _option_sets_match_jax(opts, mode, nsub):
    a = _arrays(16, 24, seed=5)
    mp_j = JP.microphysics_1m_params(**opts)
    mp_t = TP.microphysics_1m_params(**opts)
    ref = JC.step_column_1m(_jax_state(a, jnp.float64), mp_j, TPS_J, TV_J,
                            10.0, DZ, mode=mode, nsub=nsub)
    out = TC.step_column_1m(_torch_state(a, torch.float64), mp_t, TPS_T,
                            TV_T, 10.0, DZ, mode=mode, nsub=nsub)
    _assert_f64(out, ref, f"{_option_id(opts)} {mode}")


@pytest.mark.parametrize("opts", OPTION_SETS, ids=_option_id)
def test_step_column_1m_option_sets_match_jax_f64(opts):
    _option_sets_match_jax(opts, "instantaneous", 1)


def test_mixed_option_set_linearized_matches_jax_f64():
    _option_sets_match_jax(OPTION_SETS[-1], "linearized_average", 2)


def test_fused_linearized_matches_pallas_f32():
    # the wrapper's plain path against the Pallas kernel in interpret mode,
    # the way tests/test_kernels.py runs the JAX package's kernel on the CPU
    a = _arrays(32, 16, seed=3)
    ref = JK.step_column_1m_pallas(_jax_state(a, jnp.float32), MP_J, TPS_J,
                                   TV_J, 10.0, DZ, mode="linearized_average",
                                   nsub=2, block_cols=16, interpret=True)
    out = TK.step_column_1m_fused(_torch_state(a, torch.float32), MP_T,
                                  TPS_T, TV_T, 10.0, DZ,
                                  mode="linearized_average", nsub=2,
                                  block_cols=16)
    _assert_f32(out, ref, "linearized_average nsub=2")


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
    names = ("launches.step_column_1m_fused",
             "launches.step_column_1m_fused_packed")
    before = [trace.counter(n) for n in names]
    TK.step_column_1m_fused(st, MP_T, TPS_T, TV_T, DT, DZ, block_cols=8)
    TK.step_column_1m_fused_packed(TK.pack_state(st), MP_T, TPS_T, TV_T, DT,
                                   DZ, block_cols=8)
    assert [trace.counter(n) for n in names] == before


# ---------------------------------------------------------------------------
# what the CUDA path accepts, and the kernel's parameter buffer
# ---------------------------------------------------------------------------

# what the kernel still rejects: an unknown mode or option, nsub < 1 (as
# the eager step does), a dtype other than float32 and float64, no levels
@pytest.mark.parametrize("mp,mode,nlev,dtype,nsub,error,match", [
    (MP_T, "instantaneous_verbose", 16, torch.float32, 1, ValueError,
     "unknown tendency mode"),
    (MP_T, "linearized_average", 16, torch.float32, 0, ValueError, "nsub"),
    (MP_T, "instantaneous", 16, torch.bfloat16, 1, NotImplementedError,
     "float32 and float64"),
    (MP_T, "instantaneous", 0, torch.float32, 1, ValueError, "nlev"),
    (dataclasses.replace(MP_T, processes=dataclasses.replace(
        MP_T.processes, snow_melt="SnowMeltFast")), "instantaneous", 16,
     torch.float32, 1, ValueError, "unknown snow_melt option"),
])
def test_cuda_path_rejects_what_the_kernel_lacks(mp, mode, nlev, dtype, nsub,
                                                 error, match):
    with pytest.raises(error, match=match):
        TK._check_supported(mp, mode, nlev, dtype, nsub)


def test_cuda_path_accepts_float_overrides():
    mp = TP.microphysics_1m_params(
        process_overrides={"Kessler1M": {"tau": 900.0}})
    TK._check_supported(mp, "instantaneous", 512, torch.float32)


@pytest.mark.parametrize("mode,nsub", [("instantaneous", 1),
                                       ("linearized_average", 1),
                                       ("linearized_average", 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nlev", [16, 333, 512, 1024])
def test_cuda_path_accepts_the_whole_scope(mode, nsub, dtype, nlev):
    TK._check_supported(MP_T, mode, nlev, dtype, nsub)


def test_instantaneous_ignores_nsub_as_the_eager_step_does():
    # the instantaneous build takes no substeps: an nsub of 0 is accepted
    # and launches as 1, as the eager step ignores it in that mode
    TK._check_supported(MP_T, "instantaneous", 16, torch.float32, 0)
    assert TK._kernel_nsub("instantaneous", 0) == 1
    assert TK._kernel_nsub("linearized_average", 4) == 4
    st = _torch_state(_arrays(16, 8), torch.float64)
    ref = TK.step_column_1m_fused(st, MP_T, TPS_T, TV_T, DT, DZ, nsub=1,
                                  block_cols=8)
    out = TK.step_column_1m_fused(st, MP_T, TPS_T, TV_T, DT, DZ, nsub=0,
                                  block_cols=8)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opts", OPTION_SETS, ids=_option_id)
def test_options_select_the_build(opts):
    # each option slot is one macro of the generated header: 0 disabled, 1
    # the default option, 2 the alternative; the mode is one more
    mp = TP.microphysics_1m_params(**opts)
    TK._check_supported(mp, "linearized_average", 16, torch.float32, 2)
    for mode in TK.MODES:
        variant = TK.variant(mp, mode)
        header = TK.header(TK.kernel_params(mp, TPS_T, TV_T), variant)
        assert f"#define K1_LINEARIZED {int(mode != 'instantaneous')}\n" \
            in header
        for slot, options in TK.OPTION_CODES.items():
            option = getattr(mp.processes, slot)
            code = 0 if option is None else 1 + options.index(option)
            assert f"#define K1_OPT_{slot.upper()} {code}\n" in header
    assert TK.variant(mp) != TK.DEFAULT_VARIANT


@pytest.mark.parametrize("opts", OPTION_SETS, ids=_option_id)
def test_parameter_block_per_option_set(opts):
    # one parameter list for every variant; a slot that is not selected
    # leaves its values 0, the selected alternatives carry theirs
    mp = TP.microphysics_1m_params(**opts)
    values = TK._param_values(mp, TPS_T, TV_T)
    assert set(values) == set(TK.PARAM_NAMES)
    block = TK.kernel_params(mp, TPS_T, TV_T)
    assert bool(torch.isfinite(block).all())
    pp, processes = mp.process_params, mp.processes
    slot_values = {
        "cloud_liquid_formation": ("TAU_LCL",),
        "rain_snow_accretion": ("E_RS", "CD_RS"),
        "cloud_ice_rain_accretion": ("E_IR",),
        "cloud_ice_snow_accretion": ("E_IS",),
        "cloud_liquid_rain_accretion": ("E_LR",),
        "cloud_liquid_snow_accretion": ("E_LS",)}
    for slot, names in slot_values.items():
        for name in names:
            assert (values[name] == 0) == (getattr(processes, slot) is None), \
                (slot, name)
    kessler = processes.rain_autoconversion == "Kessler1M"
    assert (values["INV_ACNV_R_TAU"] != 0) == kessler
    if processes.rain_autoconversion == "PrescribedNd":
        r = pp.rain_autoconversion
        assert values["INV_ACNV_PND"] == 1 / (r.tau * (r.Nc / 1e8) ** r.alpha)
    else:
        assert values["INV_ACNV_PND"] == 0
    if processes.snow_autoconversion == "WithSupersaturation":
        r_is = pp.snow_autoconversion.r_ice_snow
        assert (values["R_IS"], values["NEG_R_IS"]) == (r_is, -r_is)
    else:
        assert values["R_IS"] == values["R_IS2_DELTA"] == 0
    if processes.cloud_ice_formation == "TemperatureDependent":
        fr = pp.cloud_ice_formation.frostenberg
        assert values["FR_NEG_B"] == -fr.b and values["FR_LOG_A"] == fr.log_a
        assert values["FR_T_FREEZE"] == fr.T_freeze
    else:
        assert values["FR_T_FREEZE"] == 0


def test_float64_header_round_trips_exactly():
    block = TK.kernel_params(MP_T, TPS_T, TV_T, torch.float64)
    assert block.dtype == torch.float64
    header = TK.header(block)
    assert "#define K1_REAL double\n" in header
    literals = re.findall(r"#define PC_\w+ \((\S+)\)", header)
    assert len(literals) == len(TK.PARAM_NAMES)
    assert not any(x.endswith("f") for x in literals)
    assert [float.fromhex(x) for x in literals] == block.tolist()
    # the float64 block holds the float64 thresholds and folds, unrounded
    values = TK._param_values(MP_T, TPS_T, TV_T, torch.float64)
    assert block.tolist() == [values[n] for n in TK.PARAM_NAMES]
    assert values["EPS"] == torch.finfo(torch.float64).tiny ** (1 / 3)
    assert values["EPS_MACH"] == torch.finfo(torch.float64).eps
    assert values["TINY"] == 1e-50
    f32 = TK._param_values(MP_T, TPS_T, TV_T)
    assert f32["EPS"] != values["EPS"] and f32["TINY"] == 1e-25
    assert "#define K1_REAL float\n" in TK.header(TK.kernel_params(
        MP_T, TPS_T, TV_T))


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


def _source():
    """csrc/column1m.cu without its comments."""
    src = (_build.CSRC_DIR / "column1m.cu").read_text()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def test_cuda_source_reads_exactly_the_parameter_list():
    # the generated header is the only link between the list and
    # csrc/column1m.cu: every name the source reads must be in it, and it
    # reads them through PV(), as the header's literals, never from memory
    src = _source()
    assert "#define PV(name) (PC_##name)" in src
    used = set(re.findall(r"PV\((\w+)\)", src)) - {"name"}
    assert used == set(TK.PARAM_NAMES)
    assert re.findall(r"\bPC_\w+", src) == []   # no literal outside PV()
    assert "__ldg(P" not in src and "__restrict__ P" not in src
    header = TK.header(TK.kernel_params(MP_T, TPS_T, TV_T))
    names = re.findall(r"#define PC_(\w+) ", header)
    assert tuple(names) == TK.PARAM_NAMES
    assert f"#define N_PARAMS {len(TK.PARAM_NAMES)}\n" in header


def test_header_holds_each_value_exactly():
    block = TK.kernel_params(MP_T, TPS_T, TV_T)
    header = TK.header(block)
    literals = re.findall(r"#define PC_\w+ \((\S+)f\)", header)
    assert len(literals) == len(TK.PARAM_NAMES)
    assert [float.fromhex(x) for x in literals] == block.tolist()
    # another block is another header, so another build of the library
    mp = TP.microphysics_1m_params(
        process_overrides={"RainSnowAccretion": {"e": 0.7}})
    assert TK.header(TK.kernel_params(mp, TPS_T, TV_T)) != header
    with pytest.raises(ValueError, match=f"{len(TK.PARAM_NAMES)} values"):
        TK.header(block[:10])
    with pytest.raises(ValueError, match="non-finite"):
        TK.header(torch.where(torch.arange(len(block)) == 3,
                              torch.tensor(float("inf")), block))


def _reciprocal_sources(mp, tps, tv):
    """What each INV_* parameter is the reciprocal of: the Python float the
    eager step divides a tensor by there (None for an option slot that is
    not selected, whose value is 0)."""
    eps = float(torch.finfo(torch.float32).tiny) ** (1.0 / 3.0)
    aps, pp = mp.air_properties, mp.process_params
    rain, snow = mp.precip.rain.mass, mp.precip.snow.mass
    return {
        "INV_T_TRIPLE": tps.T_triple, "INV_R_V": tps.R_v,
        "INV_K_THERM_SAFE": max(aps.K_therm, eps),
        "INV_D_VAPOR_SAFE": max(aps.D_vapor, eps),
        "INV_NU_AIR": aps.nu_air,
        "INV_ACNV_R_TAU": pp.rain_autoconversion.tau,
        "INV_ACNV_S_TAU": pp.snow_autoconversion.tau,
        "INV_GC_RAI": rain.gamma_coeff, "INV_GC_SNO": snow.gamma_coeff,
        "INV_R0D_RAI": rain.r0 ** (rain.me + rain.dm),
        "INV_R0D_SNO": snow.r0 ** (snow.me + snow.dm),
        "INV_NU_STOKES": tv.stokes.nu_air,
        "INV_N0_LCL": mp.cloud.liquid.N_0,
        "INV_RHO_W_LCL": mp.cloud.liquid.rho_w,
        "INV_N0_ICL_SED": mp.cloud.ice.N_0,
        "INV_RHO_I_ICL": mp.cloud.ice.rho_i,
        "INV_TEN": 10.0,
        "INV_ACNV_PND": None,
    }


@pytest.mark.parametrize("overrides", [
    {}, {"Kessler1M": {"tau": 900.0}, "RainSnowAccretion": {"e": 0.7}}])
def test_reciprocal_params_are_folded_in_float64(overrides):
    # PyTorch's CUDA `x / c` for a Python float c multiplies by 1/c taken in
    # float64 and rounded once; the kernel multiplies by the same float32
    mp = TP.microphysics_1m_params(process_overrides=overrides)
    sources = _reciprocal_sources(mp, TPS_T, TV_T)
    names = [n for n in TK.PARAM_NAMES if n.startswith("INV_")]
    assert set(names) == set(sources)
    p = TK.kernel_params(mp, TPS_T, TV_T)
    for name in names:
        want = (0.0 if sources[name] is None else
                np.float32(np.float64(1.0) / np.float64(sources[name])))
        assert p[TK.PARAM_NAMES.index(name)].item() == float(want), name


def test_prescribed_nd_divisor_is_folded_in_float64():
    # clamp_to_nonneg(q_lcl) / (tau (Nc / 1e8)^alpha): a division by a
    # Python float, a multiply by its reciprocal taken in float64
    mp = TP.microphysics_1m_params(
        rain_autoconversion="PrescribedNd",
        process_overrides={"PrescribedNd": {"tau": 900.0, "Nc": 3e8,
                                            "alpha": 0.5}})
    c = 900.0 * (3e8 / 1e8) ** 0.5
    i = TK.PARAM_NAMES.index("INV_ACNV_PND")
    assert TK.kernel_params(mp, TPS_T, TV_T)[i].item() == float(
        np.float32(1.0 / c))
    assert TK.kernel_params(mp, TPS_T, TV_T, torch.float64)[i].item() == \
        1.0 / c


def _functions(src):
    """name -> (parameter names, body) of every __device__ function."""
    out = {}
    for m in re.finditer(r"__device__ __forceinline__ \w+ (\w+)\(([^)]*)\)"
                         r"\s*\{", src):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        params = [a.split()[-1].lstrip("&*") for a in m.group(2).split(",")
                  if a.strip()]
        out[m.group(1)] = (params, src[m.end():i])
    return out


def _call_args(src, name):
    """The argument lists of every call of ``name`` in ``src``."""
    calls = []
    for m in re.finditer(rf"\b{name}\(", src):
        depth, i, args, start = 1, m.end(), [], m.end()
        while depth:
            ch = src[i]
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            elif ch == "," and depth == 1:
                args.append(src[start:i].strip())
                start = i + 1
            i += 1
        args.append(src[start:i - 1].strip())
        calls.append(args)
    return calls


# The eager step's logistic integral (ops/common.py) divides by x0 and k
# held as device tensors: true divisions, which the kernel keeps.
TENSOR_DIVISORS = {("logistic_integral", "x0s"), ("logistic_integral", "k"),
                   ("logistic_translation", "k")}


def _parameter_divisions(src):
    """Divisions in ``src`` whose divisor is a parameter: PV(...) or
    PVO(...), a local alias of one, a float literal (``3.0f``; a double
    constant such as ``(1.0 / 3.0)`` is a host fold), or a function argument
    that some call fills with one of these."""
    aliases = set(re.findall(
        r"(?:\b(?:float|real|R)\s+|,\s*)(\w+) = PVO?\(\w+\)(?=[;,])", src))
    from_param = set()
    for fname, (params, _) in _functions(src).items():
        for args in _call_args(src, fname):
            for pname, arg in zip(params, args):
                if re.fullmatch(r"PVO?\(\w+\)", arg) or arg in aliases:
                    from_param.add((fname, pname))
    bad = []
    for m in re.finditer(
            r"/\s*(PVO?\(\w+\)|p\.v\[|[A-Za-z_]\w*|[\d.]+f?)", src):
        divisor = m.group(1)
        if (divisor.startswith(("PV(", "PVO(", "p.v[")) or divisor in aliases
                or divisor[0] in "0123456789." and divisor.endswith("f")):
            bad.append(divisor)
    for fname, (params, body) in _functions(src).items():
        for m in re.finditer(r"/\s*([A-Za-z_]\w*)", body):
            if ((fname, m.group(1)) in from_param
                    and (fname, m.group(1)) not in TENSOR_DIVISORS):
                bad.append(f"{fname}: {m.group(1)}")
    return bad


def test_cuda_source_divides_by_no_parameter():
    assert _parameter_divisions(_source()) == []


def test_parameter_division_check_finds_each_form():
    # the check above would see a division by a parameter in each form
    cases = ["x = a / PV(T_FREEZE);",
             "const float K_safe = PV(K_THERM); x = a / K_safe;",
             "__device__ __forceinline__ float f(float a, float c) "
             "{ return a / c; }\n y = f(x, PV(NU_AIR));",
             "x = a / p.v[3];", "x = logf(a) / 3.0f;",
             "x = a / PVO(XR_MIN);",
             "const float em = PV(EM), en = PV(EN); x = a / en;",
             "const R em = PV(EM), en = PV(EN); x = a / en;",
             "const real q_min = PV(Q_MIN); x = a / q_min;"]
    for case in cases:
        assert _parameter_divisions(case), case
    assert _parameter_divisions("x = a / rho_dz; y = (1.0f / x) * c;") == []


# ---------------------------------------------------------------------------
# the slice as a whole: Column1MStep for 5 steps vs 5 JAX steps, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_column1m_step_five_steps_matches_jax(packed):
    a = _arrays(64, 16)
    js = _jax_state(a, jnp.float64)
    for _ in range(5):
        js = JC.step_column_1m(js, MP_J, TPS_J, TV_J, DT, DZ)
    model = TC.Column1MStep(MP_T, TPS_T, TV_T, DT, DZ, device="cpu")
    st = _torch_state(a, torch.float64)
    x = TK.pack_state(st) if packed else st
    for _ in range(5):
        x = model(x)
    out = TK.unpack_state(x) if packed else x
    _assert_f64(out, js, "Column1MStep x5")
    for v in out:
        assert bool(torch.isfinite(v).all())


@pytest.mark.parametrize("packed", [True, False])
def test_column1m_step_module_takes_the_step_scope(packed):
    # Column1MStep gains step_column_1m's mode, nsub and sediment_cloud, and
    # steps a float64 state with a float64 block (float32 stays params)
    a = _arrays(32, 16, seed=3)
    js = _jax_state(a, jnp.float64)
    for _ in range(3):
        js = JC.step_column_1m(js, MP_J, TPS_J, TV_J, 10.0, DZ,
                               mode="linearized_average", nsub=4,
                               sediment_cloud=False)
    model = TC.Column1MStep(MP_T, TPS_T, TV_T, 10.0, DZ, device="cpu",
                            mode="linearized_average", nsub=4,
                            sediment_cloud=False)
    assert (model.mode, model.nsub, model.sediment_cloud) == (
        "linearized_average", 4, False)
    st = _torch_state(a, torch.float64)
    x = TK.pack_state(st) if packed else st
    for _ in range(3):
        x = model(x)
    _assert_f64(TK.unpack_state(x) if packed else x, js,
                "Column1MStep linearized_average x3")
    assert model.params.dtype == torch.float32
    block = model.block(torch.float64)
    assert block.dtype == torch.float64 and model.block(torch.float64) is block
    assert torch.equal(block, TK.kernel_params(MP_T, TPS_T, TV_T,
                                               torch.float64))
    assert model.block(torch.float32) is model.params
    assert model.block(torch.bfloat16) is None
