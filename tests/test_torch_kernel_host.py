"""The host side the kernel modules share (kernels/_build.py), on the CPU:
the host parameter block of the 1M and 2M kernels, what tells two
libraries apart, the one library cache (each library loaded and bound
once; a stand-in library in place of an nvcc build), the launch tail, the
columns a thread block steps, and that no kernel module imports another's
private names."""

import ast
import ctypes.util
import dataclasses

import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.kernels import _build
from cloudmicrophysics_tpu_torch.kernels import column1m as K1
from cloudmicrophysics_tpu_torch.kernels import column2m as K2
from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
from cloudmicrophysics_tpu_torch.kernels import roof as R
from cloudmicrophysics_tpu_torch.models import column as TC
from test_torch_column1m import MP_T as MP1, OPTION_SETS, TPS_T, TV_T
from test_torch_column2m import MP_T as MP2, OPTIONS as OPTIONS_2M

DT, DZ = 1.0, 100.0

# what the host-block tests need of each kernel module with a block built
# into its library: the module, the arguments of its block after
# (params, ...) and before dtype, its variant of a parameter set, and its
# step module
BLOCK_KERNELS = {
    "column1m": (K1, (MP1, TPS_T, TV_T), lambda mp: K1.variant(mp),
                 lambda: TC.Column1MStep(MP1, TPS_T, TV_T, DT, DZ,
                                         device="cpu")),
    "column2m": (K2, (MP2, TPS_T), K2.warm_variant,
                 lambda: TC.Column2MStep(MP2, TPS_T, DT, DZ, device="cpu")),
}


def _kernel_params(K, *args):
    return (K.kernel_params if K is K1 else K.kernel_params_2m)(*args)


@pytest.mark.parametrize("name", BLOCK_KERNELS)
def test_host_params_is_the_block_the_kernel_is_built_for(name):
    K, args, variant, model = BLOCK_KERNELS[name]
    p = K.host_params(None, *args)
    assert p.device.type == "cpu" and p.dtype == torch.float32
    assert p.shape == (len(K.PARAM_NAMES),) and p.is_contiguous()
    values = K._param_values(*args)
    assert p.tolist() == [float(np.float32(values[n]))
                          for n in K.PARAM_NAMES]
    v = variant(args[0])
    assert K.header(p, v) == K.header(_kernel_params(K, *args), v)
    step = model()
    assert torch.equal(step.params, p)
    assert step.to("cpu").params.device.type == "cpu"


@pytest.mark.parametrize("name", BLOCK_KERNELS)
def test_host_params_makes_no_copy(monkeypatch, name):
    # choosing a CUDA-bound call's library reads the host block in place:
    # no transfer, no copy, no synchronising read of a device value
    K, args, variant, _ = BLOCK_KERNELS[name]
    block = _kernel_params(K, *args)

    def refuse(*a, **k):
        raise AssertionError("a copy or transfer of the parameter block")

    for method in ("to", "cpu", "cuda", "clone", "copy_", "item",
                   "contiguous"):
        monkeypatch.setattr(torch.Tensor, method, refuse)
    assert K.host_params(block, *args) is block
    assert f"#define PC_{K.PARAM_NAMES[0]} " in K.header(
        block, variant(args[0]))
    monkeypatch.undo()
    # a block anywhere but on the host is refused, not copied back
    with pytest.raises(ValueError, match="host parameter block"):
        K.host_params(torch.empty(len(K.PARAM_NAMES), device="meta"), *args)
    with pytest.raises(ValueError, match="host parameter block"):
        K.host_params(block.double(), *args)


def _cases_1m():
    mps = [TP.microphysics_1m_params(**o) for o in [{}] + OPTION_SETS]
    other = TP.microphysics_1m_params(
        process_overrides={"RainSnowAccretion": {"e": 0.7}})
    return ([(mp, K1.variant(mp, mode)) for mp in mps for mode in K1.MODES],
            (other, K1.variant(other)), (TPS_T, TV_T))


def _cases_2m():
    mps = [TP.microphysics_2m_params(**o) for o in OPTIONS_2M]
    other = dataclasses.replace(MP2, warm_rain=dataclasses.replace(
        MP2.warm_rain, seifert_beheng=TP.sb2006(accr={"kcr": 6.0})))
    return ([(mp, K2.warm_variant(mp)) for mp in mps],
            (other, K2.warm_variant(other)), (TPS_T,))


@pytest.mark.parametrize("K,cases", [(K1, _cases_1m), (K2, _cases_2m)],
                         ids=["column1m", "column2m"])
def test_library_key_tells_variants_apart(K, cases):
    # a library is looked up by its source and build, the block's dtype and
    # bytes and the variant: each distinct one is its own library
    cases, (other, other_variant), rest = cases()
    keys = set()
    for mp, variant in cases:
        for dtype in (torch.float32, torch.float64):
            block = _kernel_params(K, mp, *rest, dtype)
            for build in K.BUILDS:
                keys.add(_build.library_key(K.SOURCE, build, variant, block))
    assert len(keys) == len(cases) * 2 * len(K.BUILDS)
    # another value of one parameter is another block, so another library
    block = _kernel_params(K, other, *rest)
    key = _build.library_key(K.SOURCE, "kernel", other_variant, block)
    assert key not in keys
    # and the same call twice is the same library
    assert key == _build.library_key(K.SOURCE, "kernel", other_variant,
                                     _kernel_params(K, other, *rest))


def _libc():
    path = ctypes.util.find_library("c")
    if path is None:
        pytest.skip("no C library to stand in for a kernel library")
    return path


# each kernel module's look-ups through its _library: a first one, the
# same again, and (but for the roof's one build) another build or variant;
# and the name of its bind
LOOK_UPS = {
    "column1m": (K1, "bind", lambda: K1._library(K1.kernel_params(
        MP1, TPS_T, TV_T)), lambda: K1._library(K1.kernel_params(
            MP1, TPS_T, TV_T), "probe")),
    "column2m": (K2, "bind", lambda: K2._library(
        K2.kernel_params_2m(MP2, TPS_T), K2.warm_variant(MP2)),
        lambda: K2._library(K2.kernel_params_2m(MP2, TPS_T, torch.float64),
                            K2.warm_variant(MP2))),
    "column_p3": (K5, "_bind", lambda: K5._library("kernel", K5.Variant()),
                  lambda: K5._library("kernel", K5.Variant(order=8))),
    "roof": (R, "_bind", lambda: R._library(), None),
}


@pytest.mark.parametrize("name", LOOK_UPS)
def test_shared_cache_binds_a_library_once(monkeypatch, name):
    """Each kernel module's ``_library`` goes through the one cache of
    ``_build``: the library is built (``library_path``), loaded and bound
    once, and every later look-up returns that object and builds nothing;
    another build or variant is another library. The C library stands in
    for an nvcc build."""
    K, bind_name, look_up, another = LOOK_UPS[name]
    libc = _libc()
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    paths, bound = [], []
    monkeypatch.setattr(K, "library_path",
                        lambda *a, **k: paths.append(a) or libc)
    monkeypatch.setattr(K, bind_name,
                        lambda lib, *a, **k: bound.append(lib) or lib)
    loads = _build.loads()
    lib = look_up()
    assert isinstance(lib, ctypes.CDLL) and bound == [lib]
    assert look_up() is lib and look_up() is lib
    assert len(paths) == 1 and bound == [lib]
    assert _build.loads() == loads + 1
    if another is not None:
        second = another()
        assert second is not lib and bound == [lib, second]
        assert another() is second and len(paths) == 2
        assert _build.loads() == loads + 2


def test_library_formats_no_header_on_a_hit(monkeypatch):
    """``_build.library`` calls ``path`` (where a module formats its header
    and builds) and ``bind`` at the first look-up only, inside the span
    ``kernels.load``."""
    libc = _libc()
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    calls = []

    def path():
        calls.append("path")
        return libc

    def bind(lib):
        calls.append("bind")
        return lib

    block = torch.arange(3, dtype=torch.float32)
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        lib = _build.library("stand_in.cu", "kernel", (1,), path, bind,
                             block=block)
        for _ in range(3):
            assert _build.library("stand_in.cu", "kernel", (1,), path, bind,
                                  block=block.clone()) is lib
    assert calls == ["path", "bind"]
    assert trace.totals()["kernels.load"]["count"] == 1
    trace.reset()
    # another block's bytes, dtype or variant is another look-up
    _build.library("stand_in.cu", "kernel", (1,), path, bind,
                   block=block + 1)
    _build.library("stand_in.cu", "kernel", (1,), path, bind,
                   block=block.double())
    _build.library("stand_in.cu", "kernel", (0,), path, bind, block=block)
    assert calls == ["path", "bind"] * 4


def test_launch_raises_on_a_cuda_error_and_counts_a_launch():
    def column1m_step_packed(*args):
        return args[0]

    before = trace.counter("launches.stand_in")
    _build.launch(column1m_step_packed, 0, 1.0, span="launch.k1",
                  counter="stand_in")
    assert trace.counter("launches.stand_in") == before + 1
    with pytest.raises(RuntimeError, match="column1m_step_packed launch "
                       "failed: CUDA error 700"):
        _build.launch(column1m_step_packed, 700, counter="stand_in")
    assert trace.counter("launches.stand_in") == before + 1
    _build.launch(column1m_step_packed, 0)     # no span, uncounted
    assert trace.counter("launches.stand_in") == before + 1


def _old_block_cols(ncol, most):
    """models/column.py's rule before the one rule: ``most`` (a power of
    two), or the largest power of two that divides ``ncol``."""
    return ncol & -ncol if ncol % most else most


@pytest.mark.parametrize("most", [2 ** k for k in range(9)])
def test_fit_block_cols_is_the_power_of_two_rule(most):
    for ncol in range(1025):
        assert _build.fit_block_cols(ncol, most) == _old_block_cols(
            ncol, most), ncol


def test_fit_block_cols_halves_any_width():
    # the halving rule of the JAX package's step_column_2m, for widths that
    # are not a power of two, and no columns
    assert _build.fit_block_cols(96, 96) == 96
    assert _build.fit_block_cols(48, 96) == 48
    assert _build.fit_block_cols(24, 96) == 24
    assert _build.fit_block_cols(64, 96) == 1
    assert _build.fit_block_cols(0, 96) == 96
    assert _build.fit_block_cols(0, 0) == 1
    assert _build.fit_block_cols(7, 0) == 1
    # every cell's width: 1m_linavg/1m_inst, p3_gl16/p3_gl40, 2m_fields
    assert _build.fit_block_cols(1_649_920, K1.BLOCK_COLS) == 32
    assert _build.fit_block_cols(12_288, K5.BLOCK_COLS) == 128
    assert _build.fit_block_cols(1_048_576, 128) == 128


def test_no_kernel_module_imports_a_private_name_of_another():
    names = {p.stem for p in _build.KERNELS_DIR.glob("*.py")}
    for path in sorted(_build.KERNELS_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.ImportFrom) and node.level == 1
                    and node.module in names):
                private = [a.name for a in node.names
                           if a.name.startswith("_")]
                assert not private, (path.name, node.module, private)
