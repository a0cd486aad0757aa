"""The point-wise fused 2M + P3 tendencies on the CPU, where
``bulk_microphysics_tendencies`` takes its eager code, against the
benchmark's frozen host step (``bench_h100/reference/tendencies_p3.py``):

* the port's rates and its shape solve's log lambda against the frozen
  ones at GL-16 and GL-40, float64 and float32, on the cell
  ``p3_tend_gl40``'s recipe at 64 x 16: clear columns (ice-free points),
  mixed-phase points and a nonzero per-point INP log shift. Tolerance:
  none, bit for bit, since the frozen modules are copies of the port's
  eager code, operation for operation, run on the same device;
* the INP shift is wired: None is a zero shift, bit for bit, and a shift
  moves the nucleation and immersion-freezing rates where they act;
* the route's rule: a call takes the kernel route with a field on a CUDA
  device; the kernels track no derivative, so a field that autograd,
  forward-mode AD or ``torch.func`` tracks raises there, and CPU calls keep
  the eager path and its gradients (the reference's AD contract: log
  lambda an input, held fixed); a gradient through a CPU call is finite;
* the counters ``tendencies.points`` and ``tendencies.kernel_points``;
  ``tendencies.ice_points``, which the card adds to and ``trace.counter``
  reads (a CPU call adds nothing), and the benchmark's reader of their
  share, ``tendencies.ice_share``;
* the kernel entry's fields (``kernels/column_p3.tend_inputs``): None,
  Python numbers, 0-d tensors, broadcast shapes and strided fields made
  into full contiguous fields
  that the eager code answers bit for bit as it answers the call; CPU
  fields never reach the kernel entry, which refuses them and fields it
  cannot take.
"""

import sys
from pathlib import Path

import pytest
import torch

from cloudmicrophysics_tpu_torch import trace
from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
from cloudmicrophysics_tpu_torch.models import tendencies as TT
from cloudmicrophysics_tpu_torch.parameters import (
    ThermodynamicsParameters,
    microphysics_2m_params,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import harness  # noqa: E402
from bench_h100 import reference as BR  # noqa: E402
from bench_h100.drivers import p3_tendencies as D  # noqa: E402
from bench_h100.reference import tendencies_p3 as R  # noqa: E402

TPS = ThermodynamicsParameters()
SEED = 2**34 + 26
NCOL, NLEV = 64, 16


def _state(dtype, seed=SEED):
    config = dict(harness.load_cell("p3_tend_gl40")[2], nlev=NLEV)
    return D.make_state(config, NCOL, seed, "cpu", dtype)


def _port(mp, state, loglam, shift):
    return TT.bulk_microphysics_tendencies(
        mp, TPS, *state[:len(R.PROGNOSTIC)], loglam, shift)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", [16, 40])
def test_port_equals_the_frozen_host_step(order, dtype):
    state = _state(dtype)
    # the recipe's cover: clear columns, mixed-phase points, a shift
    assert bool(((state.q_lcl == 0) & (state.q_ice == 0)).any())
    assert bool(((state.q_lcl > 0) & (state.q_ice > 0)).any())
    assert float(state.inpc_log_shift.abs().max()) > 1.0
    mp = microphysics_2m_params(with_ice=True, quadrature_order=order)
    ref_new, ref_ll = R.step(state, None, *BR.params_p3(order), 10.0)
    ll = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp)
    assert torch.equal(ll.isfinite(), ref_ll.isfinite())
    assert torch.equal(ll[ll.isfinite()], ref_ll[ref_ll.isfinite()])
    rates = _port(mp, state, ll, state.inpc_log_shift)
    for name, got in zip(R.RATES, rates):
        want = getattr(ref_new, name)
        assert got.dtype == dtype
        assert torch.equal(got, want), name
    # the warm-started second step too
    ref2, ref_ll2 = R.step(ref_new, ref_ll, *BR.params_p3(order), 10.0)
    ll2 = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*ref_new[:len(R.PROGNOSTIC)]), mp, ref_ll)
    assert torch.equal(ll2[ll2.isfinite()], ref_ll2[ref_ll2.isfinite()])
    for name, got in zip(R.RATES, _port(mp, ref_new, ll2,
                                        ref_new.inpc_log_shift)):
        assert torch.equal(got, getattr(ref2, name)), name


def test_the_inp_shift_is_wired():
    state = _state(torch.float64)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=16)
    ll = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp)
    none = _port(mp, state, ll, None)
    zero = _port(mp, state, ll, torch.zeros_like(ll))
    shifted = _port(mp, state, ll, state.inpc_log_shift)
    assert all(torch.equal(a, b) for a, b in zip(none, zero))
    # the shift moves the ice number where F23 nucleates or caps freezing
    moved = none.dn_ice_dt != shifted.dn_ice_dt
    assert bool(moved.any())
    # and the warm rain's own rates nowhere without ice processes there
    assert torch.equal(none.dq_rai_dt, shifted.dq_rai_dt)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: the route's rule
    tested without a card."""

    @property
    def is_cuda(self):
        return True


def _fields(requires_grad=False):
    state = _state(torch.float64)
    out = [torch.Tensor._make_subclass(_OnCard, t.contiguous(),
                                       requires_grad)
           for t in state[:len(R.PROGNOSTIC)]]
    ll = torch.full_like(state.rho, 9.0)
    return out + [ll, state.inpc_log_shift]


def test_the_route_rule_keeps_tracked_calls_eager():
    # tracked fields on the card raise; CPU calls keep the eager path and
    # their gradients (test_a_gradient_through_the_p3_call_is_finite)
    fields = _fields()
    assert TT.p3_on_card(fields)
    assert not TT.p3_on_card([torch.ones(3)] * 12 + [None])
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    tracked = _fields(requires_grad=True)
    with pytest.raises(NotImplementedError, match="track no derivative"):
        TT.bulk_microphysics_tendencies(mp, TPS, *tracked)
    assert any(K5.tracked(t) for t in tracked)
    with torch.no_grad():
        assert not any(K5.tracked(t) for t in tracked)
    # forward-mode AD and torch.func transforms raise too
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        dual = fwAD.make_dual(fields[1], torch.ones_like(fields[1]))
        with pytest.raises(NotImplementedError, match="track no derivative"):
            TT.bulk_microphysics_tendencies(mp, TPS, fields[0], dual,
                                            *fields[2:])

    seen = []

    def probe(T):
        seen.append(K5.tracked(T))
        return T

    torch.func.jvp(probe, (fields[1],), (torch.ones_like(fields[1]),))
    torch.func.vmap(probe)(fields[1])
    assert seen == [True, True]
    assert not any(K5.tracked(t) for t in fields)


def test_a_gradient_through_the_p3_call_is_finite():
    # the reference's AD contract: log lambda is an input, held fixed
    state = _state(torch.float64)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    ll = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp)
    T = state.T.clone().requires_grad_(True)
    fields = list(state[:len(R.PROGNOSTIC)])
    fields[1] = T
    out = TT.bulk_microphysics_tendencies(mp, TPS, *fields, ll,
                                          state.inpc_log_shift)
    (g,) = torch.autograd.grad(out.dq_ice_dt.sum(), T)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_counters_count_the_p3_calls():
    state = _state(torch.float32)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    ll = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp)
    names = ("tendencies.points", "tendencies.kernel_points",
             "launches.p3_tendencies_fused")
    before = [trace.counter(n) for n in names]
    _port(mp, state, ll, state.inpc_log_shift)
    # a warm-rain call is no P3 call
    TT.bulk_tendencies_2m(microphysics_2m_params(), TPS,
                          *state[:len(R.PROGNOSTIC)][:7])
    # the column step's eager call with its step-shared context counts
    from cloudmicrophysics_tpu_torch.models.column import step_column_p3

    step_column_p3(K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp, TPS,
                   1.0, 250.0)
    after = [trace.counter(n) for n in names]
    assert [a - b for a, b in zip(after, before)] == [2 * NCOL * NLEV, 0, 0]


def test_fused_entry_takes_the_plain_version_on_cpu():
    # CPU fields take the plain version; the kernel entry refuses them
    state = _state(torch.float32)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    fields = state[:len(R.PROGNOSTIC)]
    ll = K5.loglambda_p3_plain(K5.ColumnStateP3(*fields), mp)
    before = trace.counter("launches.p3_tendencies_fused")
    got = TT.bulk_microphysics_tendencies(mp, TPS, *fields, ll,
                                          state.inpc_log_shift)
    want = TT.bulk_tendencies_2m_plain(mp, TPS, *fields, ll,
                                       state.inpc_log_shift)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trace.counter("launches.p3_tendencies_fused") == before
    with pytest.raises(ValueError, match="launches on CUDA fields"):
        K5.p3_tendencies_fused(mp, TPS, *fields, ll, state.inpc_log_shift)
    on_card = _fields()
    with pytest.raises(ValueError, match="do not broadcast"):
        K5.tend_inputs(on_card[:-2] + [on_card[-2][:, :3], None])
    with pytest.raises(ValueError, match="differ in device or dtype"):
        K5.tend_inputs(on_card[:-2] + [on_card[-2].float(), None])
    with pytest.raises(ValueError, match="differ in device or dtype"):
        K5.tend_inputs(on_card[:-1] + [torch.tensor(0.3)])
    with pytest.raises(TypeError, match="not str"):
        K5.tend_inputs(on_card[:-1] + ["0"])
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        K5.tend_inputs([t.half() for t in on_card])
    assert K5.TEND_FIELDS == TT.Tendencies2M._fields
    assert set(K5.TEND_BUILDS) == {"tend", "tend_probe"}
    assert all("-DK5_TEND" in flags for flags in K5.TEND_BUILDS.values())


def _plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


# fields as a host may hand them: (index in the call, value from the state)
FIELD_FORMS = {
    "ice, log lambda and shift None": lambda st, ll: {
        k: None for k in range(7, 13)},
    "numbers": lambda st, ll: {11: 9.5, 12: -0.75},
    "broadcast profile and columns": lambda st, ll: {
        1: st.T[:1], 2: st.q_tot[:, :1].contiguous(), 11: ll[:1, :1]},
    "0-d tensors": lambda st, ll: {
        6: st.n_rai.new_tensor(2.5e5), 12: st.rho.new_tensor(0.3)},
    "strided": lambda st, ll: {
        3: st.q_lcl.t().contiguous().t(),
        12: st.inpc_log_shift.t().contiguous().t()},
}


@pytest.mark.parametrize("form", list(FIELD_FORMS))
def test_the_kernel_entry_takes_the_fields_as_the_eager_code(form):
    """tend_inputs' full fields, answered by the eager code, give the eager
    code's answer to the call as the host made it, bit for bit (the kernel
    is held bit for bit to that eager answer on the card)."""
    state = _state(torch.float64)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    ll = K5.loglambda_p3_plain(
        K5.ColumnStateP3(*state[:len(R.PROGNOSTIC)]), mp)
    call = list(_fields()[:len(R.PROGNOSTIC)]) + [ll, state.inpc_log_shift]
    for k, v in FIELD_FORMS[form](state, ll).items():
        call[k] = v
    inputs, shift = K5.tend_inputs(call)
    assert len(inputs) == 12
    for t in inputs + ([] if shift is None else [shift]):
        assert t.shape == (NCOL, NLEV) and t.dtype == torch.float64
        assert t.is_contiguous()
    assert (shift is None) == (call[12] is None)
    want = TT.bulk_tendencies_2m_plain(mp, TPS, *map(_plain, call))
    got = TT.bulk_tendencies_2m_plain(mp, TPS, *map(_plain, inputs), shift)
    for name, a, b in zip(TT.Tendencies2M._fields, got, want):
        assert torch.equal(a, b.expand_as(a)), name


def test_a_device_counter_is_folded_in_when_read():
    """``trace.device_counter``: one int64 0-d tensor a name and device,
    zero when first asked for, that kernels add to where it lies; the step
    path never reads it, and ``trace.counter`` adds its value to the host's
    adds each time the counter is read (reading adds nothing). The P3
    tendency route's is ``tendencies.ice_points``."""
    name = "test.device_counter_fold"
    acc = trace.device_counter(name, "cpu")
    assert acc.dtype == torch.int64 and acc.shape == () and int(acc) == 0
    assert trace.device_counter(name, torch.device("cpu")) is acc
    assert trace.counter(name) == 0
    acc += 5                      # what a launch adds on its device
    trace.count(name, 2)
    assert trace.counter(name) == 7
    assert trace.counter(name) == 7
    acc += 1
    assert trace.counter(name) == 8
    assert K5.ICE_POINTS == "tendencies.ice_points"


def test_a_cpu_call_runs_no_node_pass_on_the_card():
    # the eager path counts its points, never the kernel's ice points
    state = _state(torch.float32)
    mp = microphysics_2m_params(with_ice=True, quadrature_order=8)
    fields = state[:len(R.PROGNOSTIC)]
    ll = K5.loglambda_p3_plain(K5.ColumnStateP3(*fields), mp)
    names = ("tendencies.points", "tendencies.ice_points")
    before = [trace.counter(n) for n in names]
    TT.bulk_microphysics_tendencies(mp, TPS, *fields, ll,
                                    state.inpc_log_shift)
    after = [trace.counter(n) for n in names]
    assert [a - b for a, b in zip(after, before)] == [NCOL * NLEV, 0]


class _Registry:
    """A program's counters as the benchmark's readers see them, with or
    without device counters (``trace.device_counter``)."""

    def __init__(self, counters, device_counters=True):
        self.counters = counters
        if device_counters:
            self.device_counter = trace.device_counter

    def counter(self, name):
        return self.counters.get(name, 0)


@pytest.mark.parametrize("counters,device_counters,want", [
    (None, True, None),                                     # no registry
    ({"tendencies.kernel_points": 5443200}, False, None),   # no counter
    ({}, True, None),                                       # no kernel call
    ({"tendencies.kernel_points": 200, "tendencies.ice_points": 70}, True,
     0.35),
    ({"tendencies.kernel_points": 200, "tendencies.ice_points": 200}, True,
     1.0),
    ({"tendencies.kernel_points": 200}, True, 0.0),         # no ice
])
def test_the_ice_share_reader(monkeypatch, counters, device_counters, want):
    """``bench_h100/metrics/tendencies.ice_share.py``: the points whose node
    pass ran over the route's points, 0.0 where none ran, None for a
    program without the counter (a checkout before it) or without a kernel
    call."""
    reader = harness.load_metric("tendencies.ice_share")
    monkeypatch.setattr(reader, "registry", lambda: (
        None if counters is None else _Registry(counters, device_counters)))
    assert reader.read(None) == want


def test_the_ice_share_is_a_metric_of_the_tendency_cell():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "tendencies.ice_share"]
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "P3 point-wise tendency route"
    assert entry["moves"] == "points_per_s"
    assert entry["workloads"] == ["p3_tend_gl40"]
    assert [m["name"] for m in harness.cell_metrics(
        bench, "p3_tend_gl40", "per_layer")][-1] == "tendencies.ice_share"
