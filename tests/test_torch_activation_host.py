"""The host side of the ARG2000 kernels (kernels/activation.py) and the
CPU path of ops/aerosol_activation.py, on the CPU:

* how a launch classes each field (a Python number, a one-element tensor,
  a contiguous tensor of the state's shape, any other broadcast, which is
  materialised) and what it refuses;
* the parameter block's constants: each is a scalar the eager code's own
  arithmetic applies (recorded by a ``TorchFunctionMode`` around the eager
  call, a divisor as its reciprocal), and every scalar it applies is in
  the block or written in the kernel;
* Python's sums of products as the eager code evaluates them (the leading
  products of Python numbers added in double);
* the launch check that refuses a dtype other than float32 and float64;
* a ``ModeB`` mode passed as one hygroscopicity field;
* the parameter block of the cell ``arg_mam4``'s state, field by field;
* every ``__global__`` of ``csrc/activation.cu`` lies in the benchmark's
  ``arg`` group (``bench_h100/drivers/activation.py``'s ``Cell.kernels``);
* CPU inputs take the eager path: no launch, two S_max evaluations a point,
  and gradients as before;
* a launch refuses a field that requires a gradient while autograd
  records.
"""

import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch
from torch.overrides import TorchFunctionMode

from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.kernels import activation as A
from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA
from cloudmicrophysics_tpu_torch.parameters import (
    AirProperties,
    ThermodynamicsParameters,
)
from cloudmicrophysics_tpu_torch.parameters.aerosol import (
    AerosolActivationParameters,
    AerosolDistribution,
    ModeB,
    ModeKappa,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.drivers import activation as D  # noqa: E402
from bench_h100.reference import activation as R  # noqa: E402

AP, AIP, TPS = (AerosolActivationParameters(), AirProperties(),
                ThermodynamicsParameters())
CONFIG = ROOT / "bench_h100" / "configs" / "atmos_mam4.json"
F64 = torch.float64
SHAPE = (6, 5)


def _air(dtype=F64, q_number=False, shape=SHAPE):
    g = torch.Generator().manual_seed(3)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype)

    T, p = u(250.0, 300.0), u(6e4, 1e5)
    q_liq = 0.0 if q_number else u(0.0, 1e-3)
    q_ice = 0.0 if q_number else u(0.0, 1e-4)
    return (T, p, u(0.2, 2.0), u(5e-3, 1.5e-2), q_liq, q_ice, u(0.0, 1e8),
            u(0.0, 1e5))


def _modes(dtype=F64, shape=SHAPE):
    g = torch.Generator().manual_seed(4)
    vol = torch.rand(shape, generator=g, dtype=dtype)
    return AerosolDistribution(modes=(
        ModeKappa(r_dry=0.05e-6 + 0 * vol, stdev=1.8, N=1e8 * (1 + vol),
                  vol_mix_ratio=(vol, 1 - vol), mass_mix_ratio=(vol, 1 - vol),
                  molar_mass=(0.132, 0.058), kappa=(0.53, 1.16)),
        ModeKappa(r_dry=1e-6, stdev=2.1, N=1e6, vol_mix_ratio=(1.0,),
                  mass_mix_ratio=(1.0,), molar_mass=(0.058,),
                  kappa=(1.16,))))


# ---------------------------------------------------------------------------
# Fields
# ---------------------------------------------------------------------------

FIELD_CASES = {
    "Python float": (lambda: 1.5, "number"),
    "Python int": (lambda: 2, "number"),
    "0-d tensor": (lambda: torch.tensor(1.5, dtype=F64), "one"),
    "one-element tensor": (lambda: torch.full((1, 1), 1.5, dtype=F64),
                           "one"),
    "full shape": (lambda: torch.rand(SHAPE, dtype=F64), "full"),
    "a column": (lambda: torch.rand(SHAPE[0], 1, dtype=F64), "broadcast"),
    "a level": (lambda: torch.rand(SHAPE[1], dtype=F64), "broadcast"),
    "transposed": (lambda: torch.rand(SHAPE[::-1], dtype=F64).t(),
                   "broadcast"),
}


@pytest.mark.parametrize("case", FIELD_CASES)
def test_each_field_is_classed_and_a_broadcast_materialised(case):
    make, want = FIELD_CASES[case]
    value = make()
    kind, x = A.field_kind(value, SHAPE, torch.device("cpu"), F64)
    assert kind == want
    if kind == "number":
        assert x == float(value) and isinstance(x, float)
    elif kind in ("one", "full"):
        assert x is value
    else:
        assert x.is_contiguous() and x.shape == SHAPE
        assert torch.equal(x, value.expand(SHAPE))


@pytest.mark.parametrize("shapes", [
    [(6, 5), (6, 1), (5,), ()], [(1,), ()], [(2, 1, 3), (4, 1)],
    [(0,), (1,)], [(3, 0), (1, 1)], [(6, 5), (4, 5)], [(0,), (3,)]])
def test_broadcast_shape_is_torchs(shapes):
    try:
        want = tuple(torch.broadcast_shapes(*shapes))
    except RuntimeError:
        with pytest.raises(ValueError, match="do not broadcast"):
            A.broadcast_shape(set(shapes))
        return
    assert A.broadcast_shape(set(shapes)) == want


@pytest.mark.parametrize("value,error", [
    (torch.ones(SHAPE, dtype=torch.float32), ValueError),
    (torch.ones(SHAPE, dtype=F64, device="meta"), ValueError),
    ("1.5", TypeError),
])
def test_a_field_the_kernel_cannot_read_raises(value, error):
    with pytest.raises(error):
        A.field_kind(value, SHAPE, torch.device("cpu"), F64)


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

# the names torch's function mode gives the arithmetic of a tensor and a
# Python number (``c - x`` is ``__rsub__``, ``c / x`` is ``__rdiv__``)
_ARITHMETIC = {"add", "sub", "mul", "div", "pow", "lt", "clamp", "__rsub__",
               "__rdiv__"}


class _Scalars(TorchFunctionMode):
    """The Python numbers the eager code applies to tensors, a divisor
    (``x / c``) as its reciprocal, which is what the kernel multiplies by."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _ARITHMETIC:
            for a in (*args[1:], *kwargs.values()):
                if isinstance(a, (int, float)) and not isinstance(a, bool):
                    self.seen.add(1 / a if name == "div" else a)
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("q_number", [False, True])
def test_the_block_holds_the_scalars_the_eager_code_applies(dtype, q_number):
    air, ad = _air(dtype, q_number), _modes(dtype)
    with _Scalars() as mode:
        AA.N_activated_per_mode_plain(AP, ad, AIP, TPS, *air)
        AA.M_activated_per_mode_plain(AP, ad, AIP, TPS, *air)
    consts = A.kernel_constants(AP, AIP, TPS, dtype, air[4], air[5])
    # q_liq and q_ice as tensors: the kernel multiplies them by CPLV and
    # CPIV; as Python numbers the eager code folds the products, which the
    # block holds (0 here)
    unused = {"CPLV_QL", "CPIV_QI"} if not q_number else {"CPLV", "CPIV"}
    for name, value in consts.items():
        if name not in unused:
            assert value in mode.seen, name
    # every scalar applied is a constant of the block, a field's Python
    # number (the second mode's N and 1 / r_dry, the Python products N / 2
    # and M / 2 its answers are scaled by) or one the kernel writes itself
    # (torch.clamp's 0, a min of floatmin, x * 2, x * 3, x / 2, 1 - x, 1 / x)
    fields = {0.132, 0.058, 0.53, 1.16, 1e6, 1 / 1e-6, 1e6 * 0.5, 0.058 / 2}
    written = {0, 0.0, 1, 2, 3, 0.5, torch.finfo(dtype).tiny}
    assert mode.seen <= set(consts.values()) | fields | written, (
        mode.seen - set(consts.values()) - fields - written)


def test_python_q_folds_into_the_heat_capacity_products():
    c = A.kernel_constants(AP, AIP, TPS, F64, 1e-3, 2e-4)
    # cp_m's Python arithmetic with Python-number contents
    assert (c["CP_D"] + c["CPLV_QL"] + c["CPIV_QI"]
            == TPS.cp_d + (TPS.cp_v - TPS.cp_d) * 0.0
            + (TPS.cp_l - TPS.cp_v) * 1e-3 + (TPS.cp_i - TPS.cp_v) * 2e-4)
    assert c["EPS"] == torch.finfo(F64).eps


@pytest.mark.parametrize("e,code", [(1.5, 0), (0.75, 0), (1 / 3, 0),
                                    (2, 6), (3.0, 7), (0.5, 3), (-1, 5)])
def test_pow_code_follows_torchs_lowering(e, code):
    assert A.pow_code(e) == code


def test_python_sums_of_products_as_the_eager_code_adds_them():
    t = torch.ones(())
    start, terms = A.sum_terms([(0.5, 2.0), (0.25, 4.0), (t, 3.0),
                                (1.5, 2.0), (2.0, t)])
    assert start == 0.5 * 2.0 + 0.25 * 4.0
    assert terms == [(t, 3.0), (3.0, 1.0), (2.0, t)]
    assert A.sum_terms([(t, 1.0)]) == (0, [(t, 1.0)])
    assert A.sum_terms([]) == (0, [])


# ---------------------------------------------------------------------------
# Launch checks and the parameter block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_the_launch_check_refuses_another_dtype(dtype):
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        A.check_dtype(dtype)
    air = tuple(x.to(dtype) if isinstance(x, torch.Tensor) else x
                for x in _air())
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        A.launch_params(AP, _modes(dtype), AIP, TPS, air, mass=False)


def test_the_launch_refuses_a_number_state_and_no_modes():
    air = list(_air())
    air[1] = 9e4
    with pytest.raises(NotImplementedError, match="p as a tensor"):
        A.launch_params(AP, _modes(), AIP, TPS, tuple(air), mass=False)
    with pytest.raises(NotImplementedError, match="need a mode"):
        A.launch_params(AP, AerosolDistribution(modes=()), AIP, TPS, _air(),
                        mass=False)


@pytest.mark.parametrize("tensor_fields", [False, True])
def test_a_mode_b_passes_its_hygroscopicity_as_one_field(tensor_fields):
    frac = torch.rand(SHAPE, dtype=F64) if tensor_fields else 1.0
    mode = ModeB(r_dry=1.5e-6, stdev=2.1, N=1e6, mass_mix_ratio=(frac,),
                 soluble_mass_frac=(0.9,), osmotic_coeff=(0.9,),
                 molar_mass=(0.058,), dissoc=(2.0,), aerosol_density=(2160.,))
    ad = AerosolDistribution(modes=(mode,))
    p, layout, shape, keep = A.launch_params(AP, ad, AIP, TPS, _air(),
                                             mass=True)
    kinds, hyg_first, hyg_count, mass_first, mass_count, _ = layout
    hyg = AA.mean_hygroscopicity_parameter(AP, ad)[0]
    k = len(A.AIR) + 3
    field = p.f[k]
    assert hyg_count == (0,)
    # the mass: one (molar mass, fraction) pair on the card, or a Python sum
    assert mass_count == ((1,) if tensor_fields else (0,))
    assert p.f[k + 1].val == (0.0 if tensor_fields else 0.058)
    if tensor_fields:
        assert kinds[k] == A.KINDS["full"]
        assert any(torch.equal(t, hyg) and t.data_ptr() == field.ptr
                   for t in keep)
    else:
        assert kinds[k] == A.KINDS["number"]
        assert field.ptr is None and field.val == hyg
    h, terms = A.hygroscopicity(AP, mode)
    assert terms == [] and (torch.equal(h, hyg) if tensor_fields
                            else h == hyg)


@pytest.mark.parametrize("mass", [False, True])
def test_the_block_and_layout_of_the_cells_state(mass):
    cfg = json.loads(CONFIG.read_text())
    layout = R.Layout(cfg)
    state = D.make_state(cfg, 3, 11, "cpu")
    ad = layout.distribution(state, ModeKappa, AerosolDistribution)
    air = layout.air(state)
    p, lay, shape, keep = A.launch_params(AP, ad, AIP, TPS, air, mass)
    kinds, hyg_first, hyg_count, mass_first, mass_count, pows = lay
    assert shape == (3, cfg["nlev"]) and p.n == 3 * cfg["nlev"]
    number, full = A.KINDS["number"], A.KINDS["full"]
    for k, x in enumerate(air):
        assert p.f[k].ptr == x.data_ptr() and kinds[k] == full
    reads = [f for f in p.f if f.ptr is not None]
    species = [len(m["species"]) for m in cfg["modes"]]
    # the air, each mode's N and r_dry, its volume (and mass) fractions:
    # the mass kernel's fields, which the number kernel's block leaves unset
    assert len(reads) == 8 + 2 * 4 + sum(species) * (2 if mass else 1)
    assert len({f.ptr for f in reads}) == len(reads)
    assert hyg_count == mass_count == tuple(species)
    assert pows == (0, 0, 0, 0)

    def f32(x):   # a value as the float32 block holds it
        return float(torch.tensor(x, dtype=torch.float32))

    for m, spec in enumerate(cfg["modes"]):
        base = len(A.AIR) + A.MODE_FIELDS * m
        assert kinds[base: base + 5] == (full, full, number, number, number)
        assert p.f[base + 2].val == f32(spec["stdev"])
        assert p.f[base + 3].val == 0.0
        for j, s in enumerate(spec["species"]):
            vol = getattr(state, f"vol_{spec['name']}_{s}")
            k = hyg_first[m] + 2 * j
            assert p.f[k].ptr == vol.data_ptr() and kinds[k] == full
            assert p.f[k + 1].val == f32(cfg["species"][s]["kappa"])
            k = mass_first[m] + 2 * j
            assert kinds[k: k + 2] == (number, full)
            assert p.f[k].val == (f32(cfg["species"][s]["molar_mass"])
                                  if mass else 0.0)
    assert list(p.c) == [f32(v) for v in A.kernel_constants(
        AP, AIP, TPS, torch.float32).values()]
    # one build serves the cell's every state: the header is the layout's
    other = A.launch_params(AP, layout.distribution(
        D.make_state(cfg, 5, 12, "cpu"), ModeKappa, AerosolDistribution),
        AIP, TPS, layout.air(D.make_state(cfg, 5, 12, "cpu")), not mass)
    assert other.layout == lay
    header = A.header(torch.float32, lay)
    assert "#define ARG_MODES 4" in header
    assert f"#define ARG_FIELDS {len(kinds)}" in header


# ---------------------------------------------------------------------------
# The benchmark's group and the CPU path
# ---------------------------------------------------------------------------

def test_every_kernel_of_the_source_lies_in_the_benchmarks_arg_group():
    source = (ROOT / "cloudmicrophysics_tpu_torch" / "kernels" / "csrc"
              / "activation.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", source)
    assert len(names) == 2
    group = D.Cell.kernels["arg"]
    for name in names:
        assert any(k in name for k in group), name


@pytest.mark.parametrize("q_number", [False, True])
def test_cpu_inputs_take_the_eager_path(q_number):
    air, ad = _air(F64, q_number), _modes()
    names = ("activation.points", "activation.smax_points",
             "activation.kernel_points", "launches.arg_number",
             "launches.arg_mass")
    before = {n: trace.counter(n) for n in names}
    n_act = AA.N_activated_per_mode(AP, ad, AIP, TPS, *air)
    m_act = AA.M_activated_per_mode(AP, ad, AIP, TPS, *air)
    added = {n: trace.counter(n) - before[n] for n in names}
    points = math.prod(SHAPE)
    assert added == {"activation.points": points,
                     "activation.smax_points": 2 * points,
                     "activation.kernel_points": 0,
                     "launches.arg_number": 0, "launches.arg_mass": 0}
    for got, want in zip(n_act + m_act,
                         AA.N_activated_per_mode_plain(AP, ad, AIP, TPS, *air)
                         + AA.M_activated_per_mode_plain(AP, ad, AIP, TPS,
                                                         *air)):
        assert torch.equal(got, want)


GRAD_FIELDS = {
    "T": lambda air, ad: air[0],
    "w": lambda air, ad: air[2],
    "a mode's N": lambda air, ad: ad.modes[0].N,
    "a volume fraction": lambda air, ad: ad.modes[0].vol_mix_ratio[0],
}


@pytest.mark.parametrize("field", list(GRAD_FIELDS))
def test_a_launch_refuses_a_field_that_requires_a_gradient(field):
    air, ad = _air(), _modes()
    GRAD_FIELDS[field](air, ad).requires_grad_()
    for mass in (False, True):
        with pytest.raises(NotImplementedError, match="no gradient"):
            A.launch_params(AP, ad, AIP, TPS, air, mass)
        with torch.no_grad():
            assert A.launch_params(AP, ad, AIP, TPS, air, mass).shape == SHAPE


def test_cpu_inputs_keep_their_gradients():
    air, ad = _air(), _modes()
    w = air[2].requires_grad_()
    n_act = AA.N_activated_per_mode(AP, ad, AIP, TPS, *air)
    m_act = AA.M_activated_per_mode(AP, ad, AIP, TPS, *air)
    (sum(x.sum() for x in n_act) + sum(x.sum() for x in m_act)).backward()
    assert w.grad is not None and bool(w.grad.isfinite().all())
    assert float(w.grad.abs().sum()) > 0
