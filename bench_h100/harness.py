"""The general part of a run: find a cell's files by name, make its state,
warm up, step it in a closed loop for the window, read the trace, check the
answers against the reference and print the result line.

Nothing here knows a configuration, a cell or a per-layer metric by name:
``BENCHMARK.json`` names them, ``configs/<config>.json`` gives a
configuration's ``kind``, ``drivers/<kind>.py`` builds and steps it,
``workloads/<cell>.json`` holds the cell's step, frozen work and limits, and
``metrics/<metric>.py`` reads one per-layer metric from the traced window.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import check
from . import roofline

HERE = Path(__file__).resolve().parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudmicrophysics_tpu")
# steps a run may have queued on the device ahead of the one running
DEPTH = 2
# the window step whose answers are checked is drawn from 1..SAMPLE_STEPS
SAMPLE_STEPS = 50
# steps after the start step that set-up takes before the window
WARMUP = 2


class BenchError(RuntimeError):
    """A run that cannot report: no card, a missing file, JAX loaded."""


# ---------------------------------------------------------------------------
# Finding a cell's files by name
# ---------------------------------------------------------------------------

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> tuple:
    """``(entry, workload, config, bench)`` of the cell ``name``: its entry
    in ``BENCHMARK.json`` (beside ``root``'s folder), ``root/workloads/
    <name>.json``, the configuration file the entry's configuration names,
    and the whole of ``BENCHMARK.json``. Raises :class:`BenchError` for an
    unknown cell or files that disagree."""
    bench = _json(root.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = _json(root / "workloads" / f"{name}.json")
    config = _json(root.parent / configs[entry["config"]]["file"])
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise BenchError(f"workloads/{name}.json names another config or "
                         f"traffic than BENCHMARK.json")
    return entry, workload, config, bench


def load_driver(kind: str):
    """The module ``drivers/<kind>.py``."""
    return importlib.import_module(f"{__package__}.drivers.{kind}")


def load_metric(name: str, root: Path = HERE):
    """The reader ``metrics/<name>.py`` (a file name may hold dots), as a
    module whose ``read(view)`` gives the metric or None."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, name: str, section: str) -> list:
    """The entries of ``bench[section]`` that the cell ``name`` reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


# ---------------------------------------------------------------------------
# Window arithmetic
# ---------------------------------------------------------------------------

def window_metrics(points: int, step_ms, elapsed_s: float) -> dict:
    """``points_per_s`` (points advanced one step per second over the
    whole window) and ``step_ms_p95`` (95th percentile of every step's
    time)."""
    steps = len(step_ms)
    return {"points_per_s": points * steps / elapsed_s,
            "step_ms_p95": float(np.percentile(np.asarray(step_ms), 95))}


def merged(spans) -> list:
    """``spans`` (pairs of start and end) merged where they overlap, in
    order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(spans) -> float:
    """Seconds in which at least one of ``spans`` (in seconds) runs."""
    return sum(b - a for a, b in merged(spans))


def idle_share(spans, window_s: float) -> float:
    """Share of a window of ``window_s`` seconds in which none of the
    device ``spans`` runs."""
    return 1.0 - busy_seconds(spans) / window_s


class TraceView:
    """What a per-layer reader sees of the traced window: the device's
    kernels (name, start and end in seconds), the host's enqueue spans, the
    steps, the window's length, the points a step advances, the cell's
    kernel groups and its frozen work."""

    def __init__(self, kernels, enqueue_s, steps, window_s, points, groups,
                 work):
        self.kernels = kernels
        self.enqueue_s = enqueue_s
        self.steps = steps
        self.window_s = window_s
        self.points = points
        self.groups = groups
        self.work = work

    def group_seconds(self, group: str):
        """Device seconds of the kernels of ``group`` over the window, or
        None when the cell has no such group or none of them ran."""
        names = self.groups.get(group)
        if not names:
            return None
        spans = [(a, b) for n, a, b in self.kernels
                 if any(k in n for k in names)]
        return sum(b - a for a, b in spans) if spans else None

    def roofline_share(self, group: str):
        """Percent of the group's roofline bound over its device time, from
        the frozen work of the workload file; None without either."""
        seconds = self.group_seconds(group)
        if seconds is None or group not in self.work:
            return None
        bound = roofline.bound_seconds(self.work[group], self.points)
        return 100.0 * bound * self.steps / seconds


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for e in prof.events():
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == cuda:
            # the window's own annotations show on the device's track too
            if not e.name.startswith(("Memcpy", "Memset", "bench.")):
                kernels.append((e.name, *span))
        else:
            host.append((e.name, *span))
    return kernels, host


def breakdown(kernels, host, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between kernels, each named by the innermost host operation
    running at its middle."""
    totals = {}
    for name, a, b in kernels:
        totals[name] = totals.get(name, 0.0) + (b - a)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    busy = merged((a, b) for _, a, b in kernels)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                    busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:top]
    named = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        around = [(e - s, n) for n, s, e in host if s <= mid <= e]
        named.append([min(around)[1] if around else "host idle", length])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Step boundaries: CUDA events on the card; on the CPU, which steps
    eagerly, the host's clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int) -> None:
        if self.cuda:
            self.marks[i].synchronize()

    def step_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [m[i - 1].elapsed_time(m[i]) for i in range(1, len(m))]
        return [1e3 * (m[i] - m[i - 1]) for i in range(1, len(m))]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Window(NamedTuple):
    """What a window left: the steps, its length, every step's time, the
    host's enqueue spans, the checked steps' carries (``start``: the first
    step from the seeded state; ``sample``: the window step drawn from the
    seed; ``last``: the window's last step), the set-up's seconds and the
    profiler (or None)."""

    steps: int
    elapsed: float
    step_ms: list
    enqueue: list
    kept: dict
    setup_s: float
    sample: int
    prof: object
    setup_parts: dict


def drive(cell, step, seed: int, seconds: float, trace: bool,
          t_start: float, episode: int = 0) -> Window:
    """Make the cell's state from ``seed``, take the start step and
    :data:`WARMUP` more, then step in a closed loop for ``seconds``: each
    step's output is the next one's input, at most :data:`DEPTH` steps
    queued on the device, a mark at every step boundary. Every
    ``episode`` steps of the window (0: never) the loop starts again from
    the seeded state (the cell's ``restart``): with no host model's
    dynamics to feed it, a microphysics loop rains and freezes its
    condensate out and leaves the regime it starts in, and its step's cost
    with it (``tools/regime.py`` measures how soon). With ``trace``,
    ``torch.profiler`` records the window."""
    dev = cell.device
    t_drive = time.perf_counter()
    initial = cell.initial(seed)
    _sync(dev)
    t_state = time.perf_counter()
    start_out = step(initial)
    kept = {"start": (initial, start_out)}
    carry = start_out
    for _ in range(WARMUP):
        carry = step(carry)
    restart = cell.restart(initial, start_out)
    _sync(dev)
    t_warm = time.perf_counter()
    parts = {"before_state": t_drive - t_start, "state": t_state - t_drive,
             "warmup": t_warm - t_state}

    sample = random.Random(seed).randint(1, SAMPLE_STEPS)
    clock, enqueue = Clock(dev), []
    prof = record_function = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    t_window = time.perf_counter()
    clock.mark()
    steps, last = 0, None
    while time.perf_counter() - t_window < seconds:
        if episode and steps % episode == 0:
            carry = restart
        if steps >= DEPTH:
            clock.wait(steps + 1 - DEPTH)
        t0 = time.perf_counter()
        if record_function is not None:
            with record_function("bench.step"):
                out = step(carry)
        else:
            out = step(carry)
        enqueue.append(time.perf_counter() - t0)
        clock.mark()
        steps += 1
        last = (carry, out)
        if steps == sample:
            kept["sample"] = last
        carry = out
    _sync(dev)
    elapsed = time.perf_counter() - t_window
    if prof is not None:
        prof.stop()
    if last is not None:
        kept["last"] = last
    return Window(steps, elapsed, clock.step_ms(), enqueue, kept,
                  t_window - t_start, sample, prof, parts)


def check_kept(cell, kept: dict, spec: dict, dtype, seed: int) -> dict:
    """Each group's number over every checked step, against the reference
    in ``dtype`` over the columns the workload's ``check`` ``spec``
    samples."""
    columns = check.sample_columns(cell.ncol, spec.get("columns"), seed)
    block = int(spec["block_columns"])
    acc = check.GapSum(cell.groups, spec["tolerance"],
                       cell.scales(kept["start"][0]))
    for c_in, c_out in kept.values():
        check.compare(acc, cell, c_in, c_out, columns, block, dtype)
    return acc.gaps()


def run(name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", ncol=None,
        fault=None) -> dict:
    """One run of the cell ``name``; returns the result line's object.

    ``t_start``: the host clock at the process's start. ``device``: where
    the program steps; a run on the card raises :class:`BenchError` when
    there is none, or fewer than the cell asks for. ``ncol`` overrides the
    grid's columns and ``fault`` wraps the cell's step (the tests drive
    a run on the CPU with them)."""
    entry, workload, config, bench = load_cell(name)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: the benchmark runs on the card "
                             "only")
        if torch.cuda.device_count() < int(entry["chips"]):
            raise BenchError(f"{name} needs {entry['chips']} cards, "
                             f"{torch.cuda.device_count()} seen")
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    cell = load_driver(config["kind"]).Cell(config, workload, dev, ncol)
    step = cell.step if fault is None else fault(cell.step)
    w = drive(cell, step, seed, seconds, trace, t_start,
              int(workload["step"].get("episode_steps", 0)))

    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded that the run may not hold: {found}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    result = {"correct": False, "attempted": w.steps, "failed": 0,
              "metrics": {}, "device": _device(dev, peak)}
    if trace:
        kernels, host = _device_events(w.prof)
        view = TraceView(kernels, w.enqueue, w.steps, w.elapsed, cell.points,
                         cell.kernels, workload.get("work", {}))
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_metric(m["name"]).read(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = busy_seconds(
            (a, b) for _, a, b in kernels)
        result["device"]["window_s"] = w.elapsed
        result["breakdown"] = breakdown(kernels, host)
    else:
        e2e = window_metrics(cell.points, w.step_ms, w.elapsed)
        e2e["setup_s"] = w.setup_s
        for m in cell_metrics(bench, name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    # the check, once the window has closed and the peak is read
    t_check = time.perf_counter()
    spec = workload["check"]
    gaps = check_kept(cell, w.kept, spec,
                      check.DTYPES[config["reference_dtype"]], seed)
    finite = "last" in w.kept and cell.finite(w.kept["last"][1])
    limits = spec["limits"]
    failed = sum(1 for g, limit in limits.items() if not gaps[g] <= limit)
    result["failed"] = failed + (0 if finite else 1)
    result["correct"] = result["failed"] == 0 and "sample" in w.kept
    result["checks"] = {g: {"value": gaps[g], "limit": limit}
                        for g, limit in limits.items()}
    result["checks"]["nonfinite"] = {"value": 0 if finite else 1,
                                     "limit": 0}
    print(f"{name}: seed {seed}, {w.steps} steps in {w.elapsed:.6g} s, "
          f"set-up {w.setup_s:.6g} s ("
          + ", ".join(f"{k} {v:.4g}" for k, v in w.setup_parts.items())
          + f"), checked steps {sorted(w.kept)} "
          f"(window step {w.sample}) in {time.perf_counter() - t_check:.6g}"
          f" s", file=sys.stderr)
    for g, c in result["checks"].items():
        print(f"check {g} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result


def _device(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def result_line(result: dict) -> str:
    """The result as one JSON line: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and last
    ``checks``, the numbers compared, each beside its limit; infinities as
    strings, JSON having none."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        keys.append("breakdown")
    keys.append("checks")
    ordered = {k: result[k] for k in keys}
    return json.dumps(ordered, default=str,
                      allow_nan=False) if _finite(ordered) else json.dumps(
        _strings(ordered))


def _finite(obj) -> bool:
    if isinstance(obj, float):
        return math.isfinite(obj)
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    return True


def _strings(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _strings(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strings(v) for v in obj]
    return obj
