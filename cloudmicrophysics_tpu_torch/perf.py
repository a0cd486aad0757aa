"""Performance-regression harness.

Port of ``cloudmicrophysics_tpu/perf.py``, the analog of the reference's
``bench_press`` (``test/performance_tests.jl:26-76``: a per-call latency
budget, zero allocations, type stability, a return-type check). What
:func:`bench_press` enforces here:

* **latency budget** — the best of ``n_calls`` calls, timed by CUDA events
  when an argument lies on the card and by ``perf_counter_ns`` on the CPU;
* **zero build** — a second call with the same shapes and dtypes loads or
  builds no kernel library (PyTorch runs eagerly and traces nothing; what a
  repeat call must not redo is a kernel's ``nvcc`` build and load, counted
  by :func:`.kernels._build.loads`). ``n_traces`` is 1 plus the libraries
  the repeat call loaded, so the JAX package's ``n_traces == 1`` carries
  over;
* **dtype preservation** — no float output wider than the widest float
  input.

Beside it: :func:`profile_trace` (a ``torch.profiler`` trace of a block),
:func:`chunked_cells` (a function over equal chunks of the cell axis),
:func:`hbm_bytes_per_s` (a card's data-sheet memory rate, by its name) and
:func:`measure` (seconds per iteration of a self-map on the card, the
roofline's timer).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .kernels import _build

__all__ = ["bench_press", "BenchReport", "profile_trace", "chunked_cells"]


# ---------------------------------------------------------------------------
# Trees of tensors: tuples (NamedTuples too), lists and dicts
# ---------------------------------------------------------------------------

def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)


def _map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each tensor; other leaves as they
    are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, t) for k, t in tree.items()}
    return tree


def _cat(trees: list) -> Any:
    """The trees of ``trees`` (one structure) joined leaf by leaf along the
    leading axis of each tensor; other leaves from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees, dim=0)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_cat(list(parts)) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_cat(list(parts)) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _cat([t[k] for t in trees]) for k in first}
    return first


def chunked_cells(fn: Callable, n_chunks: int) -> Callable:
    """``fn`` evaluated over ``n_chunks`` equal slices of the leading (cell)
    axis of every tensor of its arguments, one slice after the other, with
    the results joined along that axis again.

    Identical math for a function that is local in its cells (a column
    step is local in its columns); the peak memory of the intermediates is
    that of one chunk, which bounds the plain P3 step's node and pair-space
    tensors on the card. Raises ``ValueError`` when ``n_chunks`` does not
    divide the leading axis of an argument's tensor.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")

    def wrapped(*args):
        for leaf in _leaves(args):
            if leaf.dim() == 0 or leaf.shape[0] % n_chunks:
                raise ValueError(
                    f"chunked_cells: {n_chunks} chunks do not divide the "
                    f"leading axis of an argument of shape "
                    f"{tuple(leaf.shape)}")
        outs = [fn(*_map(lambda t, i=i: t.chunk(n_chunks)[i], args))
                for i in range(n_chunks)]
        return _cat(outs)

    return wrapped


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace everything run inside the context with ``torch.profiler``
    (CPU, and CUDA when there is a card) and write it into ``log_dir`` as
    a Chrome trace (``trace_<pid>_<ns>.json``): the port of the JAX
    package's ``jax.profiler`` trace, the replacement for the reference's
    allocation-profile dump on a budget breach."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class BenchReport(NamedTuple):
    name: str
    best_ns: float
    budget_ns: float
    n_traces: int
    ok: bool


def _float_dtypes(tree: Any) -> set:
    return {t.dtype for t in _leaves(tree) if t.dtype.is_floating_point}


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def bench_press(
    fn: Callable,
    args: tuple,
    max_time_ns: float,
    name: str | None = None,
    n_calls: int = 10,
    check_dtype: bool = True,
) -> BenchReport:
    """Call ``fn(*args)``, enforce the three invariants, return a report.

    Raises ``AssertionError`` on a budget breach, on a kernel library built
    or loaded by a repeat call, or on dtype promotion, as the reference's
    test fails on a breached budget (test/performance_tests.jl:52-67)."""
    name = name or getattr(fn, "__name__", "<fn>")
    on_card = any(t.device.type == "cuda" for t in _leaves(args))

    out = fn(*args)
    _sync(on_card)
    loaded = _build.loads()
    fn(*args)   # same shapes and dtypes: must load no library
    _sync(on_card)
    n_traces = 1 + _build.loads() - loaded
    if n_traces != 1:
        raise AssertionError(
            f"bench_press[{name}]: the repeat call loaded {n_traces - 1} "
            f"kernel libraries: a library depends on argument values")

    if check_dtype:
        in_dt, out_dt = _float_dtypes(args), _float_dtypes(out)
        if in_dt and out_dt:
            widest = max(torch.finfo(d).bits for d in in_dt)
            bad = {d for d in out_dt if torch.finfo(d).bits > widest}
            if bad:
                raise AssertionError(
                    f"bench_press[{name}]: output promoted to {bad} from "
                    f"{in_dt} inputs")

    best = float("inf")
    for _ in range(n_calls):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e6)
        else:
            t0 = time.perf_counter_ns()
            fn(*args)
            best = min(best, time.perf_counter_ns() - t0)

    ok = best <= max_time_ns
    if not ok:
        raise AssertionError(
            f"bench_press[{name}]: best {best / 1e6:.3f} ms over budget "
            f"{max_time_ns / 1e6:.3f} ms")
    return BenchReport(name=name, best_ns=best, budget_ns=max_time_ns,
                       n_traces=n_traces, ok=ok)


# ---------------------------------------------------------------------------
# The card's data sheet and the roofline's timer
# ---------------------------------------------------------------------------

# The published HBM rate in bytes/s of each card, by the fragment of its
# name that ``torch.cuda.get_device_name`` and ``nvidia-smi`` print
# (NVIDIA's data sheets).
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,   # SXM5
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}


def hbm_bytes_per_s(name: str, rate: float | None = None) -> float:
    """The data-sheet memory rate of the card ``name`` in bytes/s, or
    ``rate`` when the caller gives one; raises ``ValueError`` for an
    unknown card without a ``rate``."""
    if rate is not None:
        return float(rate)
    found = [v for part, v in HBM_BYTES_PER_S.items() if part in name]
    if len(found) != 1:
        raise ValueError(f"no data sheet for the card {name!r}; known: "
                         f"{list(HBM_BYTES_PER_S)}")
    return found[0]


class Measurement(NamedTuple):
    best_s: float      # seconds per iteration, the best rollout
    median_s: float    # seconds per iteration, the median rollout
    last: Any          # the state after the last iteration


def measure(step: Callable, x0: Any, n_iter: int = 20,
            reps: int = 3) -> Measurement:
    """Seconds per iteration of ``step`` on the card over ``reps``
    rollouts of ``n_iter`` iterations, by CUDA events with a synchronize
    as the fence (the port of ``benchmarks/roofline.py:_measure``).

    ``step(x, s)`` is a self-map; ``s`` counts the calls (0.0 for the
    first, untimed one, which builds the kernels) and feeds only where it
    is part of the step's work, as the scales of the roofline's kernels:
    the card caches no dispatch, so nothing needs a bit-fresh input."""
    x = step(x0, 0.0)
    torch.cuda.synchronize()
    k, per_iter = 1, []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            x = step(x, float(k))
            k += 1
        end.record()
        torch.cuda.synchronize()
        per_iter.append(start.elapsed_time(end) * 1e-3 / n_iter)
    return Measurement(min(per_iter), float(np.median(per_iter)), x)
