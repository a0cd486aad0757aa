"""Spans and counters of the port, in one registry.

A **span** (:func:`span`) marks a layer boundary of the step path or of
set-up: a step module's call (``step.*``), a kernel wrapper's preparation
(``column.prepare``), a launch (``launch.*``), a library's build or load
(``kernels.*``), a part of the parcel step (``parcel.*``), an entry of
ARG2000's activation (``activation.*``). It records
only while a ``torch.profiler`` is recording. Then it is a record function of
the profiler (:data:`RECORD`), so that it lies in the profiler's trace, on
the profiler's clock, beside the device's kernels and the CUDA runtime's
calls, and it adds its count, its total nanoseconds and its self
nanoseconds (total less its child spans) to :func:`totals`. With no
profiler recording it is one shared null context: it records nothing and
costs a call and a flag test. Nothing else switches spans on.

A **counter** (:func:`count`, :func:`add_seconds`, :func:`counter`) is
always on: a plain add under a lock, for events that happen once or a few
times a step (kernel launches, library builds and loads), for the work a
launch plan sets (``k5b.node_evals``, the lane-node evaluations of K5b,
beside ``k5b.nodes``, the ice nodes it sums; ``k3.lane_slots``, the lane
slots of K3/K4's 32-cell windows, beside ``k3.cells``, the cells they
step; ``activation.smax_points`` beside ``activation.points``, the
points whose maximum supersaturation was computed and those activated)
and for set-up seconds
(:func:`timed`). A counter that a kernel adds to on the device
(:func:`device_counter`: ``tendencies.ice_points``, the points whose P3
node pass ran) is a tensor there, which the step path never reads: it is
folded into the counter only when :func:`counter` reads it, which then
waits for the device. :func:`reset` clears the span totals; counters run
for the life of the process.

Span totals are per process; the open spans are kept per thread.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["add_seconds", "count", "counter", "device_counter", "recording",
           "reset", "span", "timed", "totals"]

# The profiler's record function a recording span enters: torch's fast one,
# of function scope. torch.profiler.record_function is of user scope, and
# the profiler copies a user-scope range that encloses kernel launches onto
# the device's track as an annotation, which a reader of the trace counts
# among the device's kernels and busy time; it also costs about eight times
# as much a span.
RECORD = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_COUNTERS: dict = {}
_TOTALS: dict = {}           # name -> [count, total_ns, self_ns]
_DEVICE: dict = {}           # (name, device) -> int64 accumulator tensor
_LOCAL = threading.local()   # .open: this thread's open spans


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording (the profiler's own module
    flag, read at each call)."""
    return _profiler._is_profiler_enabled


def _open() -> list:
    try:
        return _LOCAL.open
    except AttributeError:
        _LOCAL.open = []
        return _LOCAL.open


class _Span:
    """A span that records: a :data:`RECORD` and the registry."""

    __slots__ = ("name", "_fn", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._fn = RECORD(self.name)
        self._fn.__enter__()
        _open().append(self)
        self._child = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter_ns() - self._t0
        stack = _open()
        stack.pop()
        self._fn.__exit__(*exc)
        # a span inside one of its own name (a sharded step calling itself
        # shard by shard) adds to the count and the self time, and its
        # total only through the outermost
        outermost = all(s.name != self.name for s in stack)
        with _LOCK:
            entry = _TOTALS.setdefault(self.name, [0, 0, 0])
            entry[0] += 1
            entry[1] += elapsed if outermost else 0
            entry[2] += elapsed - self._child
        if stack:
            stack[-1]._child += elapsed
        return False


def span(name: str):
    """A context that is the span ``name`` while a ``torch.profiler`` is
    recording, and a shared null context otherwise."""
    if not recording():
        return _NULL
    return _Span(name)


def totals() -> dict:
    """Each span's ``{"count", "total_ns", "self_ns"}`` since the last
    :func:`reset`, by name."""
    with _LOCK:
        return {name: {"count": c, "total_ns": t, "self_ns": s}
                for name, (c, t, s) in _TOTALS.items()}


def reset() -> None:
    """Clear the span totals (not the counters)."""
    with _LOCK:
        _TOTALS.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the integer counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def add_seconds(name: str, seconds: float) -> None:
    """Add ``seconds`` to the float counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0.0) + seconds


def counter(name: str):
    """The counter ``name``: 0 until something has been added to it. Its
    device accumulators (:func:`device_counter`) are read here, after
    their devices finish what they were given."""
    with _LOCK:
        value = _COUNTERS.get(name, 0)
        kept = [t for (n, _), t in _DEVICE.items() if n == name]
    for t in kept:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        value += int(t.item())
    return value


def device_counter(name: str, device) -> torch.Tensor:
    """The int64 0-d tensor on ``device`` that kernels add to for the
    counter ``name`` (zero when first asked for; the same tensor after
    that). Adding to it costs the step no host sync: :func:`counter` reads
    it."""
    key = (name, torch.device(device))
    with _LOCK:
        t = _DEVICE.get(key)
        if t is None:
            t = _DEVICE[key] = torch.zeros((), dtype=torch.int64,
                                           device=key[1])
        return t


@contextlib.contextmanager
def timed(name: str):
    """Add the seconds spent in the block to the counter ``name``. Also a
    decorator."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_seconds(name, time.perf_counter() - t0)
