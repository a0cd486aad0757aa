"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused 1M, 2M and 2M + P3 column kernels and the roofline's
copy kernel (K6) and ``expf`` probe from
``cloudmicrophysics_tpu_torch/kernels/csrc`` with ``nvcc`` (one compiler per
source, started together, into the package's ignored ``build/`` directory),
then, failing at the first phase that does not hold:

1. prints the toolchain (GPU name and power limit, torch, CUDA, nvcc,
   whether triton imports);
2. prints each build's time and the compiler's register/spill report;
   K1/K2's and K3/K4's registers, spills and resident blocks per SM; and
   for K5's three kernels (K5a solve, K5b node pass, K5c epilogue) of the
   GL-4, GL-8 and GL-16 builds their registers, spills, stack frame, local
   and shared memory per thread (each source is built as its kernel and
   its probe, ``BUILDS`` in ``kernels/column1m.py``, ``column2m.py`` and
   ``column_p3.py``; ``column2m.cu``, whose parameters and variant are
   compiled in, once for each 2M parameter block and variant phase 7 runs:
   default, ``is_limited=False``, Chen 2022; both 1M and 2M sources once
   more for phase 16's calibrated sets; ``column_p3.cu`` once for each
   variant of ``kernels/column_p3.variant`` that phases 10-12 and 19 run:
   dtype, quadrature order, slope law, aspect ratio, ice rain PSD); and
   the registers and resident blocks per
   SM of K6 (``copy_scale``) and the probe (``exp_chain``), both in
   ``roof.cu``;
3. compares both 1M kernel entry points (packed, K1, and unpacked, K2)
   with their plain PyTorch versions on the card at (4096, 128), ragged
   (1000, 40) and (512, 33), (96, 256), the in-kernel ``q_tot`` affine and
   ``sediment_cloud=False``, under rtol 2e-5 / atol 2e-9, checks that two
   ``block_cols`` tilings agree bit for bit, counts the comparisons that
   are bit-identical to the plain step and fails unless all are;
4. drives the main path at full width: ``Column1MStep`` over the packed
   (7, 524288, 128) float32 state of the repo's benchmark recipe, one step
   on the unpacked state and then three timed 30-step rollouts with the
   benchmark's ``q_tot`` affine schedule, checking that the result is
   finite and non-negative and that the kernels' launch counters went up
   by exactly the steps driven, and holding the one unpacked step against
   the plain version bit for bit;
5. times each kernel and its plain version at that size by CUDA events,
   holds one full-size packed step against the plain version bit for bit,
   and prints K1's stage split from its probe build (each stage's share of
   the warps' clock64 cycles: loads to first use, cell_step, the flux
   exchange, stores);
6. holds K6 (``kernels/roof.copy_step``) bit for bit against its plain
   version (``x * s + 1e-12``) at (7, 4096, 128), a ragged (7, 1001, 33),
   a view offset by one element (with a fresh output, and with an output
   offset alike), K6c's all-ones input and the full-size packed state, and
   the ``expf`` probe (``exp_chain_step``, 64 links) against its plain
   chain the same way, counting the bit-identical cases and failing on a
   miss; times K6 on the packed (7, 524288, 128) state by CUDA events (the
   memory roof every kernel is quoted against from here on) beside its
   bytes bound, its plain version and two library calls (``torch.mul``, and
   ``torch.add`` with ``alpha``, the one call that computes K6's function),
   times the probe and its plain chain, and measures the device's idle
   share over 10 fused steps with ``torch.profiler``;
7. compares both 2M warm-rain kernel entry points (packed, K3, and
   unpacked, K4) with their plain versions at (4096, 128), a ragged
   (1000, 40), (64, 512), the ``2m_fields`` cell's (1048576, 100) at its
   128 columns a block, (1000, 100) at 200 and 40 columns a block (warps
   of uneven ranges), the in-kernel ``q_tot`` affine, ``is_limited=False``,
   ``rain_velocity="chen2022"`` and the benchmark's uniform 2M state, under
   the same tolerance, with two tilings agreeing bit for bit, counts the
   comparisons that are bit-identical to the plain step and fails unless
   all are;
8. drives the 2M path at full width: ``Column2MStep`` over a packed
   (7, 524288, 128) float32 2M state, one step on the unpacked state and
   three timed 30-step rollouts with the same ``q_tot`` affine schedule,
   with the same checks, holding the unpacked step against the plain
   version bit for bit;
9. times K3 and K4 and their plain versions at that size, holds one
   full-size packed step against the plain version bit for bit, prints
   K3's stage split from its probe build (as K1's in phase 5), holding
   its count of 32-cell windows to the launch's ``k3.lane_slots``, quotes K3
   against K6's rate of phase 6, counts the plain step's device
   kernels and measures the device's idle share over 10 K3 steps;
10. holds K5a's log lambda against the plain shape solve on the ladder
    states, cold and warm-started, bit for bit; then compares the 2M + P3
    step (K5: K5a, K5b, K5c) with its plain version at quadrature
    orders 4, 8 and 16 (a build each) on the 10 curated ladder states tiled over
    (640, 16), a seeded mixed-regime (4096, 64) state and a ragged
    (1000, 40) one, each cold and warm-started from the plain step's log
    lambda, under log lambda rtol 2e-5 and fields rtol 3e-5 / atol 1e-10
    (the Pallas P3 kernel's contract), with two tilings agreeing bit for
    bit, also with ``is_limited=False`` and Chen 2022 rain, and counts the
    comparisons that are bit-identical; then prints the
    kernel's float32 per-field error against the JAX package's float64 step
    on the ladder states (the record in the package's ``data/``);
11. drives the P3 path at full width: ``ColumnP3Step`` on a (16384, 128)
    float32 state (the TPU benchmark's P3 state with rho and T profiles and
    seeded jitter) at GL-16, one cold step and three 10-step rollouts
    carrying log lambda as the next step's guess, checking finiteness,
    non-negativity, ``q_rim <= q_ice`` and the launch counters (the step's
    and each of its three kernels'), holding the cold step against the
    plain version, then one 10-step rollout at GL-8;
12. times K5 and the plain step (run in 16 column chunks) at that size,
    and each of K5a, K5b and K5c by CUDA events with the SM clock sampled
    beside them, measures the device's idle share over 10 K5 steps, prints
    the plain step's peak device memory and device kernels (counted on one
    column chunk), quotes K5 against K6's rate of phase 6, and
    counts K5's operations (kernels/opcount.py: the probe build's region
    counts on this state times each region's operations on its least path
    through the timed build's SASS; the probe's warp counts give each
    region's SIMT efficiency and each kernel's share of the warp issue
    rate) and K1-K4's (their ``cell_step`` on its least path, once per
    cell, with the global loads among its instructions, which must be
    none: their parameters are literals), for each kernel's bound: the
    larger of its bytes over the card's data-sheet memory rate and its
    operations' time, float32 operations over its float32 rate (128 lanes
    per SM, an FMA two) or MUFU operations over 16 per SM per clock, the
    larger, both at the card's maximum SM clock (``perf.hbm_bytes_per_s``
    by the card's name, and its SM count and clock: 3.35 TB/s, 132 SMs at
    1.98 GHz for the H100 SXM).
    Fails if a bound exceeds the kernel's time, or if K5b's node passes a
    cell in the probe (``R_NODE``) are not the launch plan's
    ``node_passes`` times its lanes per cell. The SASS and the probe's
    counts go to ``kernels/build/``;
13. runs the port's roofline (``cloudmicrophysics_tpu_torch.roofline``) at
    full width, with every launch counter read just before and again
    just after: K6's copy roof and the ``expf`` rate at 524288 x 128, K1
    and K3 at that size and K5 at 16384 x 128 GL-16, and prints its rows
    and each kernel's share of both roofs; fails unless every kernel of the
    roofline launched as often as it was driven;
14. gates the three step modules at full width with ``perf.bench_press``
    (budgets about 1.5 times PERF.md's times: ``Column1MStep`` 6 ms,
    ``Column2MStep`` 6.3 ms, ``ColumnP3Step`` GL-16 warm-started 47 ms;
    no library built or loaded by a repeat call; no float64 output);
15. drives the 0-D drivers and the point-wise processes under them, which
    reach no kernel of their own (plain PyTorch): the TPU benchmark's
    parcel (``benchmarks/bench_suite.py:229-242``: one float32 parcel,
    condensation, dt 0.1 s, w 1 m/s, 1000 steps a run, each run seeded by
    the last one's final state) with steps/s by CUDA events, device
    kernels per step and the device's idle share (``torch.profiler``); two
    16384-member float32 parcel ensembles, the emulator's dataset parcel
    (``models/emulator.py:284-346``, per-member parameters as tensors) and
    the Tully et al. 2023 cirrus (``examples/parcel_tully_2023.py``, its
    first 3000 steps), each checked finite and non-negative, member 0 held
    bit for bit against its own run as N = 1, and timed (steps/s and
    member-steps/s); the Alpert-Knopf box (deterministic and stochastic)
    and the P3 sandbox, float32 against float64; and, float32 against
    float64 at full width with times by CUDA events, the 2M reflectivity
    and effective radius and the 1M reflectivity over the 524288 x 128
    states, two-mode ARG activation on the 1M state's T and pressure, and
    ``het_ice_nucleation`` over the P3 state (tolerances ``TOL_*``,
    reasons in PERF.md §4);
16. drives calibration, the activation emulators and the calibrated
    parameter sets, which reach no kernel of their own apart from K1 and
    K3 (plain PyTorch, float64 Kalman updates, the GP's Cholesky solve by
    ``torch.linalg``), with the K1 and K3 launch counters read just
    before and again just after: EKI on ``tests/test_calibration.py``'s
    linear map and on its ABIFM perfect model (``calibrate_abifm`` with
    25 members and 8 iterations, float64, over the chamber's 120 s), UKI
    on both (the ABIFM route at 5 sigma points, 8 iterations, over the
    test's 60 s, against the same call on the CPU, rtol 1e-6 on theta),
    the synthetic-``.edf`` AIDA workflow; the ARG datasets on the card
    (16384 training samples, 4096 validation) and the three families
    fitted to them (the MLP, 2000 full-batch Adam steps on all, with its
    device kernels and device time a step; the GP on the first 4096; 300
    depth-5 trees on all, fitted twice and compared, their first 20 trees
    against the CPU fit), each held to ``tests/test_calibration.py``'s
    gates (the trees' train RMSE on a forest of the first 2048); the
    parcel-labelled dataset at 16384 members; and the shipped
    ``CliMA_1M`` and ``SB2006_limiters`` sets through ``Column1MStep``
    and ``Column2MStep`` (their own K1 and K3 builds, started with phase
    2's), bit for bit against the plain step at (4096, 128) and at full
    size, with their ms/step;
17. shards the column steps over ``torch.distributed``
    (``cloudmicrophysics_tpu_torch.parallel``), with each path's launch
    counter read just before each sharded run and again just after:
    (a) in this process, a one-rank NCCL group: ``Column1MStep`` on the 1M
    state (K2) and ``step_column_2m(impl="fused")`` on the 2M state (K4),
    both at 524288 x 128, and ``ColumnP3Step`` at GL-16 on the P3 state
    at 16384 x 128 (K5, cold then warm-started), each sharded with
    ``shard_columns`` and held two steps bit for bit against the unsharded
    module, then timed against it by CUDA events (rollouts of 10 steps,
    the best of 4 of each, in turns), with the host time to enqueue a step
    of each and the device's idle share over sharded steps; (b) two ranks
    sharing the card over gloo (NCCL refuses two ranks on one GPU), each
    stepping half the columns of (a)'s inputs through the same three
    paths, their shards gathered on the CPU and held bit for bit against
    (a), and the pair's ms/step by the host clock between barriers (the
    two ranks time-slice one card: not a scaling number); (c)
    ``parallel.dryrun.dryrun_multichip(2)`` on the same two ranks;
18. drives K1-K4 through the rest of the eager steps' scope (their builds,
    one per variant, started with phase 2's): it measures how PyTorch's
    CUDA kernels round float64 ``x / c`` and ``c / x`` for a Python float
    c; holds, bit for bit against the plain step at (4096, 64) and a ragged
    (512, 37), K1 and K2 in ``linearized_average`` (dt 10 s, ``nsub`` 1, 2
    and 4, ``sediment_cloud`` on and off), under each non-default option,
    each slot disabled, every slot disabled and a mixed set, and at
    float64 (both modes), K3 and K4 at float64 (each 2M variant), and
    K1-K4 at 512 and 333 levels; then, at full width (524288 x 128, and
    131072 x 512 for the levels), drives ``Column1MStep`` in
    ``linearized_average`` (``nsub`` 1 and 4) and at float64, and
    ``Column2MStep`` at float64, and both at 512 levels, with the launch
    counters read just before each and again just after, each held bit
    for bit against its plain step (on a 65536-column slice where the plain
    step's temporaries do not fit) and timed by CUDA events (best single
    launch and a 30-step rollout, packed and unpacked) beside the default
    float32 times of this run, with its bound (bytes, and the float32,
    float64 and MUFU operations of its ``cell_step`` on the least path, the
    substep loop's body counted ``nsub`` times; float64 at 64 lanes per
    SM), registers and spills; times each option set's K1 at full width;
    and holds the float64 K1-K4 to the JAX float64 record of the 1M and 2M
    steps (``data/column_records_f64.json``), printing the float32
    kernels' per-field error beside the JAX float32 step's;
19. drives ``ColumnP3Step`` through the rest of the JAX step's scope, each
    one more build of ``column_p3.cu`` (started with phase 2's): GL-40
    (ClimaAtmos's production order) and Chebyshev-Gauss 100 (the
    reference default) at float32, float64 at GL-16, 4096 x 512 at GL-16,
    and ``SlopeConstant``, ``NoAspectRatio`` and the unlimited ice rain PSD
    at GL-16, each on phase 11's cell (``p3_bench_state``, 16384 x 128,
    cast to the dtype): bit for bit against its plain step, cold and
    warm-started, through two tilings, on phase 10's ladder, mixed and
    ragged states (their column counts cut for the high orders, PERF.md
    §4; 512 and 300 levels for the 512-level path), the float64 step also
    against the JAX float64 record to ``tests/test_torch_p3_ladder.py``'s
    rtol 1e-9; then at full width a cold step and a rollout (10 steps, 3
    at CG-100) with the launch counters read just before and again just
    after (finite, non-negative, ``q_rim <= q_ice``), the cold step held
    bit for bit against the plain step (over the whole state at GL-16, in
    column chunks as phase 11's; over every 8th column at GL-40 and every
    64th at CG-100), the best single step and K5a, K5b and K5c alone by
    CUDA events, the operation count of its probe build (as phase 12's)
    for the bound, and its registers, spills and shared memory;
20. runs the twelve examples (``cloudmicrophysics_tpu_torch/examples``)
    on the card against their JAX record (``data/examples_f64.json``):
    first K5 against the plain step at every one of the squall's 120 steps
    (256 x 64, GL-8, bit for bit, each carrying its own log lambda) and K5
    one step from each recorded state of the JAX squall rollout, tiled to
    256 x 64 GL-8 and 16384 x 128 GL-16 (every column bit-equal to column
    0; per field at most twice JAX float32's own error against JAX's
    float64 step plus 1e-6); then, counting K5's launches from there,
    every example's ``run()`` (float64 parcels and box within rtol 1e-6 of
    the record, NonEq and Tully cut to each run's first 2000 steps, the
    runs that draw over 4 seeds inside the record's 16-key band; the squall
    at its script's size) and the squall at 16384 x 128 GL-16 for 120
    steps (ms/step, finite, every column bit-equal to column 0), the
    counters read just after; K5's launches in the kernels line are these.

21. holds the ARG2000 kernels (``csrc/activation.cu``, replacing no TPU
    kernel) bit for bit against their plain version (the eager code of
    ``ops/aerosol_activation.py``) on the cell ``arg_mam4``'s seeded state
    at float32 and float64 (4096 and a ragged 37 columns of 72 levels) and
    at its full 777,602 x 72 at float32, with each build's registers, local
    memory and resident blocks per SM; then times each kernel alone, each
    entry point with its host side and the plain version at that size by
    CUDA events beside each kernel's bytes bound. Each launch counter must
    rise by exactly the entry-point calls made at full size; K7's launches
    in the kernels line are that rise, its error the largest difference
    the parity checks computed.

22. holds the point-wise fused P3 tendencies (``bulk_microphysics_tendencies``
    on CUDA fields: ``csrc/column_p3.cu`` built with ``-DK5_TEND``,
    replacing no TPU kernel) bit for bit against the eager path on the
    cell ``p3_tend_gl40``'s seeded state at float32 and float64 (4096 and a
    ragged 37 columns of 63 levels) and, the route run on its full 86,400 x
    63 at float32, on every eighth column of it; prints each kernel's
    registers, local memory and shared memory; times the call, each of its
    three kernels alone, the host's shape solve (K5a) and the plain version
    (on the compared columns) by CUDA events. Read before the kernels are
    timed alone, each launch counter must have risen by exactly the entry
    point's calls at full size (a parity call, a warm-up, five timed),
    ``tendencies.points`` and ``tendencies.kernel_points`` by their points
    and ``tendencies.ice_points`` by the points of the K5b warps that hold
    ice (at GL-40 a warp a point: the host's count of points with ice).
    K5b alone is timed at ice in none, the cell's share, every other and
    every point of the grid (the tendency build skips a warp without ice).
    With ``K5_PARENT_TREE`` naming a checkout of another commit, the
    column build's SASS at GL-16 and GL-40 must be that checkout's, text
    for text.

Then it prints the ``expf`` probe's JSON object on a line of its own,
phase 15's JSON object (``{"zero_d": ...}``, with the card's name and
power limit) on another, phase 16's (``{"calibration": ...}``, likewise)
on another, phase 17's (``{"sharded": ...}``, likewise) on another,
phase 20's (``{"examples": ...}``, each example's steps, seconds, steps/s,
largest relative error and verdict) on another, phase 21's
(``{"activation": ...}``) on another, phase 22's (``{"tendencies": ...}``)
on another, the
card's name and power limit as
``nvidia-smi`` gives them, and, on the line before the last, a JSON object
with one entry per kernel (K5's with its three kernels under
``subkernels`` and phase 19's paths under ``variants``, K1-K4's with phase
18's under ``variants``); the last line
is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits with a non-zero code and prints no result.
"""

import json
import functools
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

NCOL, NLEV = 524288, 128      # the size the repo's benchmark has always run
DT, DZ = 1.0, 100.0
N_STEPS, N_ROLLOUTS = 30, 3   # the benchmark's rollout length and count
RTOL, ATOL = 2e-5, 2e-9       # the Pallas kernel's contract (tests/test_kernels.py)
AFFINE = (1.0 + 1e-4 * 5, 1e-9 * 6)
class Rates(NamedTuple):
    """The card's published rates: its HBM rate (``perf.hbm_bytes_per_s``
    by its name); its float32 rate outside the tensor cores, 128 lanes per
    SM (an FMA two operations); its special-function units' rate, 16
    results per SM per clock; its warp instruction issue rate, one per
    scheduler, four per SM, per clock; and its float64 rate, 64 lanes per SM
    (a DFMA two operations) (the CUDA C++ Programming Guide's throughput
    table, compute capability 9.0); each at the card's maximum SM clock as
    ``nvidia-smi`` reports it."""
    hbm: float
    fp32: float
    mufu: float
    warp_issue: float
    sms: int
    clock_hz: float
    fp64: float


@functools.lru_cache(maxsize=None)
def _rates():
    """The :class:`Rates` of card 0."""
    import torch

    from cloudmicrophysics_tpu_torch import perf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = 1e6 * float(_run(["nvidia-smi", "--id=0",
                              "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"]
                             ).splitlines()[0])
    return Rates(perf.hbm_bytes_per_s(torch.cuda.get_device_name(0)),
                 sms * 256 * clock, sms * 16 * clock, sms * 4 * clock, sms,
                 clock, sms * 128 * clock)


def _ops_ms(tally):
    """Least ms of an operation count (:class:`opcount.Tally`): its float32
    operations at the float32 rate, its special-function operations or its
    float64 operations at theirs, the largest."""
    r = _rates()
    return max(tally.flops / r.fp32, tally.mufu / r.mufu,
               tally.fp64 / r.fp64) * 1e3


def _bound(nbytes, tally):
    """(ms, "bytes" or "operations"): the larger of the bytes' time at the
    HBM rate and the operations' time."""
    t_bytes, t_ops = nbytes / _rates().hbm * 1e3, _ops_ms(tally)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _gpu_line():
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


# the 2M parameter options phase 7 runs, each one more build of column2m.cu
BLOCKS_2M = (("default", {}), ("is_limited=False", {"is_limited": False}),
             ("rain_velocity=chen2022", {"rain_velocity": "chen2022"}))


def _compare(out, ref):
    """Per-field (max |abs err|, max rel err, passes) of two ColumnStates."""
    rows = {}
    for name, a, b in zip(ref._fields, out, ref):
        d = (a - b).abs()
        rel = d / b.abs().clamp(min=1e-30)
        ok = bool((d <= ATOL + RTOL * b.abs()).all()) and bool(
            a.isfinite().all())
        rows[name] = (float(d.max()), float(rel.max()), ok)
    return rows


def _report(label, rows):
    bad = [n for n, r in rows.items() if not r[2]]
    print(f"  {label}: " + ", ".join(
        f"{n} abs={r[0]:.3e} rel={r[1]:.3e}" for n, r in rows.items()))
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version in {bad}")
    return max(r[0] for r in rows.values())


def _same(label, out, ref, tally):
    """Whether two ColumnStates (or two tensors) are equal bit for bit;
    prints the cells that differ per field when not, and adds the outcome
    to ``tally`` (``[identical, compared]``)."""
    import torch

    pairs = ([("values", out, ref)] if isinstance(ref, torch.Tensor)
             else zip(ref._fields, out, ref))
    diff = {n: int((a != b).sum()) for n, a, b in pairs
            if not torch.equal(a, b)}
    tally[0] += not diff
    tally[1] += 1
    print(f"  {label}: " + ("bit-identical to the plain step" if not diff
                            else f"cells differing from the plain step "
                                 f"{diff}"))
    return not diff


def _with_sm_clock(fn):
    """``fn()`` with ``nvidia-smi`` sampling the SM clock every 100 ms
    beside it; returns fn's result and a note of the clocks seen."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        result = fn()
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=10)[0].split("\n")
    rows = [r.split(",") for r in samples if r.count(",") == 1]
    clocks = [float(r[0]) for r in rows if r[0].strip().isdigit()]
    note = (f"SM clock beside them {min(clocks):g}-{max(clocks):g} MHz "
            f"({len(clocks)} samples of nvidia-smi)" if clocks
            else "SM clock not sampled")
    return result, note


def _launch_counts(wrappers, base=None):
    """Each kernel wrapper's launch counter by key (``wrappers``: key ->
    wrapper; the counter ``launches.<name>`` of the package's trace
    registry), less ``base``, an earlier reading, when given."""
    from cloudmicrophysics_tpu_torch import trace

    now = {k: trace.counter(f"launches.{fn.__name__}")
           for k, fn in wrappers.items()}
    return now if base is None else {k: now[k] - base[k] for k in now}


def _time_ms(fn, reps, warmup=1):
    """Per-call milliseconds of ``fn`` by CUDA events, ``reps`` samples."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _drive(model, state, pack, unpack, fused, packed_fused, names):
    """A path at full width: one step of ``model`` on the unpacked
    ``state``, then ``N_ROLLOUTS`` timed rollouts of ``N_STEPS`` packed
    steps with the benchmark's ``q_tot`` affine schedule, the launch
    counters read just before and again just after. Checks that the
    counters (``names``: packed, unpacked kernel) equal the steps driven
    and that the results are finite and non-negative; prints ms/step and
    grid-points/s. Returns the first step, the packed state and the
    launch counts."""
    import torch

    torch.cuda.synchronize()
    counted = dict(zip(names, (packed_fused, fused)))
    base = _launch_counts(counted)
    first = model(state)                      # one step on the unpacked state
    packed = pack(state)
    s = model(packed, q_tot_affine=(1.0, 1e-9))   # warm-up, schedule i = 0
    steps_packed = 1
    times, checksums = [], []
    for rep in range(N_ROLLOUTS):
        s = packed * (1.0 + 1e-5 * rep)       # rep-distinct start, untimed
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(N_STEPS):
            s = model(s, q_tot_affine=(1.0 + 1e-4 * (i + 1),
                                       1e-9 * (2.0 + i)))
        end.record()
        end.synchronize()
        steps_packed += N_STEPS
        times.append(start.elapsed_time(end))
        checksums.append(float(s[5].double().sum()))
    k_packed, k_unpacked = names
    launches = _launch_counts(counted, base)
    torch.cuda.synchronize()
    if launches != {k_packed: steps_packed, k_unpacked: 1}:
        raise AssertionError(f"launch counts {launches} != steps driven "
                             f"({k_packed} {steps_packed}, {k_unpacked} 1)")
    if not all(np.isfinite(checksums)):
        raise AssertionError(f"non-finite checksum {checksums}")
    for name, x in zip(("first step", "rollout end"), (first, unpack(s))):
        for f, v in zip(x._fields, x):
            if tuple(v.shape) != (NCOL, NLEV) or not bool(v.isfinite().all()):
                raise AssertionError(f"{name}: {f} not finite or misshapen")
            if f.startswith(("q_", "n_")) and bool((v < 0).any()):
                raise AssertionError(f"{name}: {f} negative")
    ms = [t / N_STEPS for t in times]
    pts = [NCOL * NLEV / (m * 1e-3) for m in ms]
    print(f"ms/step: best {min(ms):.6g}, median {float(np.median(ms)):.6g} "
          f"(per rollout {[round(m, 6) for m in ms]})")
    print(f"grid-points/s: best {max(pts):.6g}, median "
          f"{float(np.median(pts)):.6g}")
    print(f"checksum sum(q_rai) per rollout: {checksums}")
    print(f"launches in this path: {k_packed} {launches[k_packed]} "
          f"(= {steps_packed} packed steps), {k_unpacked} "
          f"{launches[k_unpacked]} (= 1 unpacked step)")
    return first, packed, launches


def _idle_share(fn, calls):
    """Share of the span from the first device kernel's start to the last
    one's end in which no kernel ran, over ``calls`` calls of ``fn``, by
    ``torch.profiler``; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + (hi - lo), a
        hi = max(hi, b)
    busy += hi - lo
    return 1.0 - busy / (hi - spans[0][0])


def _device_kernels(fn):
    """Device kernels one call of ``fn`` launches, by ``torch.profiler``
    (memory copies and sets not counted); None when the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return len(names) or None


def _k5_report_row(K5, v, label=None):
    """K5a, K5b and K5c of the build for variant ``v``: registers, local
    memory and static shared memory (CUDA runtime), spills and stack frame
    (the compiler's report). Prints a line each; returns the runtime's
    numbers with the spills."""
    from cloudmicrophysics_tpu_torch.kernels import _build

    log = (K5.library_path("kernel", v).parent / "build.log").read_text()
    report = _build.ptxas_report(log)
    attrs = K5.kernel_attrs(K5._library("kernel", v))
    names = {"K5a": "column_p3_solve_kernel",
             "K5b": f"column_p3_nodes_kernelILi{v.order}E",
             "K5c": "column_p3_epilogue_kernelILb1ELb0ELb0E"}
    for key, part in names.items():
        ptx = next((r for f, r in report.items() if part in f), {})
        a = attrs[key]
        a.update(spill_stores=ptx.get("spill_stores"),
                 spill_loads=ptx.get("spill_loads"), stack=ptx.get("stack"))
        print(f"  {key} ({label or v.tag()}): {a['registers']} registers, "
              f"{a['local_bytes']} B local memory per thread, "
              f"{a['shared_bytes']} B static shared memory; ptxas: "
              f"{ptx.get('spill_stores', '?')} B spill stores, "
              f"{ptx.get('spill_loads', '?')} B spill loads, "
              f"{ptx.get('stack', '?')} B stack frame")
    return attrs


def _k5_build_report(K5):
    """Phase 2 for K5: each kernel's registers, local memory and static
    shared memory (CUDA runtime) and its spills and stack frame (the
    compiler's report), for the GL-4, GL-8 and GL-16 (default) builds of
    phases 10-12. Returns the runtime's numbers per order."""
    from cloudmicrophysics_tpu_torch.kernels import _build

    attrs = {order: _k5_report_row(K5, K5.Variant(order=order),
                                   f"GL-{order}") for order in P3_ORDERS}
    report = _build.ptxas_report(
        (K5.library_path().parent / "build.log").read_text())
    for part in ("logLdivN", "gamma_inc_inv4"):
        ptx = next((r for f, r in report.items()
                    if part in f and "registers" not in r), None)
        if ptx:
            print(f"  {part} (called by K5a): {ptx['stack']} B stack frame, "
                  f"{ptx['spill_stores']} B spill stores")
    return attrs


def _stages(key, K, lib, packed, pass_name="warp passes", slots=None):
    """A kernel's stage split from its probe build ``lib`` (``-DK1_PROBE``
    of ``kernels/column1m.py`` or ``-DK3_PROBE`` of ``column2m.py``, the
    module ``K``) on ``packed``: each stage's share of the warps'
    ``clock64()`` cycles and its cycles per warp pass (``pass_name``: what
    a pass is), from one launch after a warm-up. With ``slots``, the name
    of the counter the launch adds its lane slots to, fails unless the
    passes the device counted, 32 lanes each, are what it added."""
    import torch

    from cloudmicrophysics_tpu_torch import trace
    from cloudmicrophysics_tpu_torch.kernels import _build

    probe_set = f"{Path(K.SOURCE).stem}_probe_set"
    sums = torch.zeros(len(K.PROBE_STAGES) + 1, dtype=torch.int64,
                       device=packed.device)
    err = getattr(lib, probe_set)(sums.data_ptr(), packed.device.index)
    if err:
        raise RuntimeError(f"{probe_set}: CUDA error {err}")

    def run():
        K.launch_packed(lib, packed, DT, DZ,
                        _build.fit_block_cols(packed.shape[1],
                                              K.BLOCK_COLS),
                        q_tot_affine=AFFINE)

    run()
    torch.cuda.synchronize()
    sums.zero_()
    before = trace.counter(slots) if slots else 0
    ms = _time_ms(run, reps=1, warmup=0)[0]
    *cycles, passes = sums.tolist()
    if slots and 32 * passes != trace.counter(slots) - before:
        raise AssertionError(
            f"{key} probe: {passes} passes of 32 lanes, but the launch added "
            f"{trace.counter(slots) - before} to {slots}")
    total = sum(cycles)
    print(f"  {key} probe build (clock64 per warp, one launch, {ms:.6g} ms): "
          f"{passes} {pass_name}; per stage share of the cycles and cycles "
          f"per pass: " + ", ".join(
              f"{s} {c / total:.4f} ({c / passes:.6g})"
              for s, c in zip(K.PROBE_STAGES, cycles)))
    return dict(zip(K.PROBE_STAGES, cycles))


# the substep loop of column1m.cu's linearized_average builds
SUBSTEP_LOOP = "for (int s = 0; s < sub.nsub; ++s)"


def _cell_ops(source, library, kernel, tag="", nsub=None):
    """Operations per cell of ``kernel`` in the ``library`` built from
    ``csrc/<source>``: its ``cell_step`` (run once per cell) on its least
    path (kernels/opcount.py), every arm's instructions, and the global
    loads (``LDG``) among them; with ``nsub`` (a linearized_average build),
    the substep loop's body is a region of its own, run ``nsub`` times a
    cell, and its least path counts that many times. Writes the SASS to
    ``kernels/build/<source><tag>.sass.gz``."""
    import gzip

    from cloudmicrophysics_tpu_torch.kernels import _build, opcount

    src = (_build.CSRC_DIR / source).read_text()
    sites = {"cell_step": opcount.function_block(src, "cell_step")}
    if nsub:
        sites["substep"] = opcount.block_at(src, SUBSTEP_LOOP)
    sass = opcount.disassemble(library)
    (_build.BUILD_DIR / f"{Path(source).stem}{tag}.sass.gz").write_bytes(
        gzip.compress(sass.encode()))
    instrs = [i for i in opcount.parse_sass(sass) if kernel in i.function]
    per_cell, every_arm = opcount.call_site_tally(instrs, sites, source,
                                                  "cell_step")
    if nsub:
        body, body_arms = opcount.call_site_tally(instrs, sites, source,
                                                  "substep")
        per_cell, every_arm = per_cell + body.scale(nsub), every_arm + body_arms
    groups, _ = opcount.attribute(instrs, sites, source)
    ldg = sum(1 for i, g in zip(instrs, groups)
              if g is not None and i.opcode.startswith("LDG"))
    return per_cell, every_arm, ldg


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from cloudmicrophysics_tpu_torch.kernels import column1m as K
    from cloudmicrophysics_tpu_torch.kernels import column2m as K2M
    from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
    from cloudmicrophysics_tpu_torch.kernels import roof as R
    from cloudmicrophysics_tpu_torch.models.bench_states import device_state
    from cloudmicrophysics_tpu_torch.models.column import (
        Column1MStep,
        Column2MStep,
        ColumnP3Step,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        microphysics_2m_params,
        terminal_velocity_params,
    )

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mp = microphysics_1m_params()
    tps = ThermodynamicsParameters()
    tv = terminal_velocity_params()
    fused, packed_fused = K.step_column_1m_fused, K.step_column_1m_fused_packed

    # ---- 1. toolchain ------------------------------------------------------
    print("== toolchain")
    gpu_line = _gpu_line()
    print(f"gpu: {gpu_line}")
    rates = _rates()
    print(f"rates: HBM {rates.hbm:.6g} B/s (data sheet), float32 "
          f"{rates.fp32:.6g} FLOP/s, float64 {rates.fp64:.6g} FLOP/s, MUFU "
          f"{rates.mufu:.6g}/s, warp issue "
          f"{rates.warp_issue:.6g}/s ({rates.sms} SMs at "
          f"{rates.clock_hz / 1e9:g} GHz)")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    from cloudmicrophysics_tpu_torch.kernels import _build

    print("nvcc: " + _run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")

    # ---- 2. build ----------------------------------------------------------
    print("== build")

    def timed_build(lib):
        t0 = time.perf_counter()
        lib()
        return time.perf_counter() - t0

    params = K.kernel_params(mp, tps, tv)
    jobs = [(f"{K.SOURCE} ({b}: {' '.join(K.BUILDS[b])})",
             lambda b=b: K._library(params, b)) for b in K.BUILDS]
    # column_p3.cu: one build per variant: phases 10-12's orders, the
    # default's probe, and each of phase 19's variants, its kernel and its
    # probe
    k5_builds = [(K5.Variant(order=o), "kernel") for o in P3_ORDERS] + [
        (K5.DEFAULT_VARIANT, "probe")] + [
        (K5.variant(m, dt), b) for _, m, dt, *_ in _k5_scope_cases(
            microphysics_2m_params) for b in K5.BUILDS]
    jobs += [(f"{K5.SOURCE} ({v.tag()}, {b}: {' '.join(K5.BUILDS[b])})",
              lambda v=v, b=b: K5._library(b, v))
             for v, b in dict.fromkeys(k5_builds)]
    jobs += [(f"{R.SOURCE} ({b}: {' '.join(R.BUILDS[b])})",
              lambda b=b: R._library(b)) for b in R.BUILDS]
    # column2m.cu: each 2M parameter block and variant phase 7 runs, and the
    # default one's probe
    blocks2m = [(tag, K2M.kernel_params_2m(m, tps), K2M._variant(m), b)
                for tag, opts in BLOCKS_2M
                for m in [microphysics_2m_params(**opts)]
                for b in (K2M.BUILDS if not opts else ("kernel",))]
    jobs += [(f"{K2M.SOURCE} ({tag}, {b}: {' '.join(K2M.BUILDS[b])})",
              lambda p=p, v=v, b=b: K2M._library(p, v, b))
             for tag, p, v, b in blocks2m]
    # phase 16's calibrated parameter sets: one more K1 and one more K3
    cal1, cal2 = _calibrated_params(tps)
    jobs += [(f"{K.SOURCE} ({CONFIG_SETS[0]}, kernel: "
              f"{' '.join(K.BUILDS['kernel'])})",
              lambda: K._library(K.kernel_params(cal1, tps, tv), "kernel")),
             (f"{K2M.SOURCE} ({CONFIG_SETS[1]}, kernel: "
              f"{' '.join(K2M.BUILDS['kernel'])})",
              lambda: K2M._library(K2M.kernel_params_2m(cal2, tps),
                                   K2M._variant(cal2), "kernel"))]
    # phase 18's variants of column1m.cu and column2m.cu
    jobs += [(f"{src} ({label})", build)
             for src, label, build in _scope_builds(K, K2M, tps, tv)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = dict(zip([j[0] for j in jobs],
                          pool.map(timed_build, [j[1] for j in jobs])))
    for stem, seconds in builds.items():
        print(f"{stem} built and loaded in {seconds:.1f} s")
    params2m, variant2m = blocks2m[0][1:3]
    for src, path in ((K.SOURCE, K.library_path(params)),
                      (K2M.SOURCE, K2M.library_path(params2m, variant2m))):
        for line in (path.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src} ptxas: {line.strip()}")
    for keys, mod, lib, path, kernel in (
            ("K1/K2", K, K._library(params), K.library_path(params),
             "column1m_step_kernel"),
            ("K3/K4", K2M, K2M._library(params2m, variant2m),
             K2M.library_path(params2m, variant2m), "column2m_step_kernel")):
        attrs = _build.kernel_attrs(lib, Path(mod.SOURCE).stem, device.index)
        ptx = _build.ptxas_report((path.parent / "build.log").read_text())
        ptx = next((v for f, v in ptx.items() if kernel in f and "stack" in v),
                   {})
        print(f"  {keys} ({kernel}): {attrs['registers']} "
              f"registers, {attrs['local_bytes']} B local memory per thread; "
              f"ptxas: {ptx.get('spill_stores', '?')} B spill stores, "
              f"{ptx.get('spill_loads', '?')} B spill loads; "
              f"{attrs['threads']} threads per block, "
              f"{attrs['blocks_per_sm']} resident blocks per SM "
              f"({attrs['threads'] * attrs['blocks_per_sm'] // 32} warps)")
    k5_attrs = _k5_build_report(K5)
    roof_log = (R.library_path().parent / "build.log").read_text()
    roof_ptx = _build.ptxas_report(roof_log)
    for prefix in R.PREFIXES:
        attrs = _build.kernel_attrs(R._library(), prefix, device.index)
        ptx = next((v for f, v in roof_ptx.items()
                    if f"{prefix}_kernel" in f and "stack" in v), {})
        print(f"  {prefix} ({R.SOURCE}): {attrs['registers']} registers, "
              f"{attrs['local_bytes']} B local memory per thread; ptxas: "
              f"{ptx.get('spill_stores', '?')} B spill stores; "
              f"{attrs['threads']} threads per block, "
              f"{attrs['blocks_per_sm']} resident blocks per SM")

    # ---- 3. kernel parity on the card --------------------------------------
    print(f"== kernel vs plain version (rtol {RTOL}, atol {ATOL})")
    max_err = {"K1": 0.0, "K2": 0.0}
    bits = [0, 0]    # K1/K2 comparisons bit-identical to the plain step, of
    cases = [("(4096, 128)", 4096, 128, (256, 128), None, True),
             ("ragged (1000, 40)", 1000, 40, (8, 40), None, True),
             ("ragged (512, 33)", 512, 33, (64, 1), None, True),
             ("(96, 256)", 96, 256, (32, 3), None, True),
             ("affine (4096, 128)", 4096, 128, (256, 64), AFFINE, True),
             ("(4096, 128) sediment_cloud=False", 4096, 128, (256, 16), None,
              False)]
    for label, ncol, nlev, tilings, affine, sed in cases:
        st = device_state(ncol, nlev, device, seed=7)
        kw = dict(q_tot_affine=affine, sediment_cloud=sed)
        ref = K.step_column_1m_plain(st, mp, tps, tv, DT, DZ, **kw)
        outs = [fused(st, mp, tps, tv, DT, DZ, block_cols=bc, params=params,
                      **kw) for bc in tilings]
        max_err["K2"] = max(max_err["K2"],
                            _report(f"K2 {label} block_cols={tilings[0]}",
                                    _compare(outs[0], ref)))
        _same(f"K2 {label}", outs[0], ref, bits)
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"K2 {label}: block_cols {tilings} differ")
        print(f"  K2 {label}: block_cols {tilings} agree bit for bit")

        pk = K.pack_state(st)
        pref = K.unpack_state(K.step_column_1m_packed_plain(
            pk, mp, tps, tv, DT, DZ, **kw))
        pouts = [packed_fused(pk, mp, tps, tv, DT, DZ, block_cols=bc,
                              params=params, **kw) for bc in tilings]
        max_err["K1"] = max(max_err["K1"], _report(
            f"K1 {label} block_cols={tilings[0]}",
            _compare(K.unpack_state(pouts[0]), pref)))
        _same(f"K1 {label}", K.unpack_state(pouts[0]), pref, bits)
        if not torch.equal(pouts[0], pouts[1]):
            raise AssertionError(f"K1 {label}: block_cols {tilings} differ")
        print(f"  K1 {label}: block_cols {tilings} agree bit for bit")
    print(f"  K1/K2 bit-identical to the plain step in {bits[0]} of {bits[1]} "
          f"comparisons")
    if bits[0] != bits[1]:
        raise AssertionError("K1/K2 differ from the plain step")
    del st, pk, ref, pref, outs, pouts

    # ---- 4. the main path at full width ------------------------------------
    print(f"== main path: Column1MStep on ({NCOL}, {NLEV}) float32, "
          f"{N_ROLLOUTS} x {N_STEPS} steps")
    state = device_state(NCOL, NLEV, device)
    model = Column1MStep(mp, tps, tv, DT, DZ, device=device)
    first, packed, launches = _drive(model, state, K.pack_state,
                                     K.unpack_state, fused, packed_fused,
                                     ("K1", "K2"))
    ref = K.step_column_1m_plain(state, mp, tps, tv, DT, DZ)
    max_err["K2"] = max(max_err["K2"], _report(
        "K2 main path's full-size step vs plain", _compare(first, ref)))
    if not _same("K2 main path's full-size step", first, ref, bits):
        raise AssertionError("K2 full-size step differs from the plain step")
    del first, ref

    # ---- 5. kernels and plain versions at full size ------------------------
    print(f"== kernel vs plain version at ({NCOL}, {NLEV}), CUDA events")
    torch.cuda.reset_peak_memory_stats(device)
    plain2 = _time_ms(lambda: K.step_column_1m_plain(
        state, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE), reps=3)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    (kern2, kern1), clock = _with_sm_clock(lambda: (
        _time_ms(lambda: fused(state, mp, tps, tv, DT, DZ,
                               params=model.params, q_tot_affine=AFFINE),
                 reps=10),
        _time_ms(lambda: model(packed, q_tot_affine=AFFINE), reps=10)))
    plain1 = _time_ms(lambda: K.step_column_1m_packed_plain(
        packed, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE), reps=3)
    timing = {"K1": (min(kern1), min(plain1)), "K2": (min(kern2), min(plain2))}
    for k, (t_kern, t_plain) in timing.items():
        print(f"  {k}: kernel {t_kern:.6g} ms/step, plain {t_plain:.6g} "
              f"ms/step, plain/kernel {t_plain / t_kern:.4g}")
    print(f"  plain version peak device memory {peak_gb:.4g} GB; K1/K2 "
          f"{clock}")
    out = K.unpack_state(model(packed, q_tot_affine=AFFINE))
    ref = K.unpack_state(K.step_column_1m_packed_plain(
        packed, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE))
    max_err["K1"] = max(max_err["K1"], _report(
        "K1 one full-size step vs plain", _compare(out, ref)))
    if not _same("K1 one full-size step", out, ref, bits):
        raise AssertionError("K1 full-size step differs from the plain step")
    del out, ref
    _stages("K1", K, K._library(model.params, "probe"), packed)

    # ---- 6. K6 and the expf probe; memory roof and idle share -------------
    k6, probe = _run_roof(device, R, packed)
    copy_ms, nbytes = k6["ms"], k6["nbytes"]
    print(f"  K1: {timing['K1'][0]:.6g} ms/step, "
          f"{nbytes / timing['K1'][0] / 1e6:.6g} GB/s, "
          f"{copy_ms / timing['K1'][0]:.4g} of K6's rate")
    idle = _idle_share(lambda: model(packed, q_tot_affine=AFFINE), calls=10)
    print("  device idle share over 10 K1 steps (torch.profiler): "
          + ("not measured, the profiler saw no device time" if idle is None
             else f"{idle:.6g}"))
    del state, packed, model

    launches2, max_err2, timing2 = _run_2m(
        device, K2M, Column2MStep, microphysics_2m_params, tps, copy_ms)
    launches.update(launches2)
    max_err.update(max_err2)
    timing.update(timing2)

    launches5, max_err5, timing5, k5 = _run_p3(
        device, K5, ColumnP3Step, microphysics_2m_params, tps,
        nbytes / copy_ms / 1e6, k5_attrs)
    launches.update(launches5)
    max_err.update(max_err5)
    timing.update(timing5)

    # ---- bounds of K1-K4: bytes, and their operations per cell ----------
    print("== K1-K4 bounds: 14 float32 fields per cell read or written, and "
          "cell_step's operations on its least path (kernels/opcount.py)")
    bounds, mufu = {}, {}    # mufu: MUFU operations per step
    limited, chen = variant2m
    cells = NCOL * NLEV
    for ks, source, library, kernel in (
            (("K1", "K2"), K.SOURCE, K.library_path(params),
             "column1m_step_kernel"),
            (("K3", "K4"), K2M.SOURCE,
             K2M.library_path(params2m, variant2m),
             f"column2m_step_kernelILb{limited}ELb{chen}E")):
        per_cell, every_arm, ldg = _cell_ops(source, library, kernel)
        if ldg:
            raise AssertionError(f"{ks}: {ldg} global loads in cell_step, "
                                 f"whose parameters are literals")
        bound = _bound(14 * 4 * cells, per_cell.scale(cells))
        rates = _rates()
        for k in ks:
            bounds[k] = bound
            print(f"  {k}: per cell {per_cell.flops:g} float32 operations, "
                  f"{per_cell.mufu:g} MUFU, {per_cell.issued:g} instructions "
                  f"issued ({every_arm:g} with every arm, {ldg} of them "
                  f"global loads); bound "
                  f"{bound[0]:.6g} ms ({bound[1]}; bytes "
                  f"{14 * 4 * cells / rates.hbm * 1e3:.4g} ms, float32 "
                  f"{per_cell.flops * cells / rates.fp32 * 1e3:.4g} ms, MUFU "
                  f"{per_cell.mufu * cells / rates.mufu * 1e3:.4g} ms), "
                  f"kernel {timing[k][0]:.6g} ms, "
                  f"{bound[0] / timing[k][0]:.4g} of the bound; issue "
                  f"{per_cell.issued * cells / 32 / rates.warp_issue * 1e3:.4g}"
                  f" ms at one warp instruction per scheduler per clock")
        mufu.update({k: per_cell.mufu * cells for k in ks})
    bounds["K5"] = (k5["bound_ms"], k5["bound_by"])
    mufu["K5"] = k5["mufu_ops"]
    bounds["K6"] = (k6["bound_ms"], "bytes")
    timing["K6"] = (k6["ms"], k6["plain_ms"])
    over = [k for k in bounds if bounds[k][0] > timing[k][0]]
    if over:
        raise AssertionError(f"{over}: bound above the measured time, so the "
                             f"count is no lower bound")

    launches.update(_run_roofline(K, K2M, K5, R, timing, mufu))
    _run_bench_press(device, K, K2M, Column1MStep, Column2MStep, ColumnP3Step,
                     mp, tps, tv, microphysics_2m_params)
    zero_d = _run_0d(device, gpu_line)
    calibration = _run_calibration(device, gpu_line, K, K2M)
    sharded = _run_sharded(device, gpu_line)
    variants = _run_scope(device, K, K2M, Column1MStep, Column2MStep, tps, tv,
                          timing, bounds)
    variants["K5"] = _run_k5_scope(device, K5, ColumnP3Step,
                                   microphysics_2m_params, tps, timing)
    examples, ex_launches = _run_examples(device, K5, gpu_line)
    activation = _run_activation(device, gpu_line)
    tendencies = _run_tendencies(device, gpu_line)
    print(f"  K5's launches: {launches['K5']} on phase 11's path, "
          f"{ex_launches['K5']} on the examples' (the kernels line's)")
    launches["K5"] = ex_launches["K5"]

    csrc = "cloudmicrophysics_tpu_torch/kernels/csrc/"
    entries = [
        ("K1", "column1m_step_packed", "column1m", "column1m.py:149"),
        ("K2", "column1m_step_unpacked", "column1m", "column1m.py:80"),
        ("K3", "column2m_step_packed", "column2m", "column2m.py:105"),
        ("K4", "column2m_step_unpacked", "column2m", "column2m.py:43"),
        ("K5", "column_p3_step", "column_p3", "column_p3.py:106"),
    ]
    kernels = [
        {"name": f"{fn} ({k})", "route": "cuda", "source": f"{csrc}{src}.cu",
         "replaces": f"cloudmicrophysics_tpu/kernels/{tpu}",
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": timing[k][0], "plain_ms": timing[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None, **({"variants": variants[k]}
                                 if k in variants else {})}
        for k, fn, src, tpu in entries]
    kernels[-1]["subkernels"] = k5["subkernels"]
    for key, sub in zip(("K5a", "K5b", "K5c"), k5["subkernels"]):
        sub["launches"] = ex_launches[key]
    kernels.append({
        "name": "copy_scale (K6, K6b, K6c)", "route": "cuda",
        "source": k6["source"],
        "replaces": "benchmarks/roofline.py:124, "
                    "benchmarks/scratch/perf_roof.py:30, "
                    "benchmarks/scratch/perf_roof2.py:21",
        "launches": launches["K6"], "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": "bytes",
        "library_ms": k6["library_ms"]})
    rows = activation["rows"]
    kernels.append({
        "name": "arg2000_number_elementwise_kernel, "
                "arg2000_mass_elementwise_kernel (K7)", "route": "cuda",
        "source": f"{csrc}activation.cu", "replaces": None,
        "launches": sum(activation["launches"].values()),
        "max_abs_err": activation["max_abs_err"],
        "ms": rows["number"]["ms"] + rows["mass"]["ms"],
        "plain_ms": rows["number"]["plain_ms"] + rows["mass"]["plain_ms"],
        "bound_ms": rows["number"]["bound_ms"] + rows["mass"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None})
    kernels.append({
        "name": "column_p3_bounds_kernel, column_p3_nodes_kernel, "
                "column_p3_tend_rates_kernel (K8)", "route": "cuda",
        "source": f"{csrc}column_p3.cu (-DK5_TEND)", "replaces": None,
        "launches": sum(tendencies["launches"].values()),
        "max_abs_err": tendencies["max_abs_err"],
        "ms": tendencies["ms"], "plain_ms": tendencies["plain_ms"],
        "bound_ms": None, "bound_by": None, "library_ms": None,
        "subkernels": tendencies["subkernels"]})
    probe["launches"] = launches["probe"]
    print(json.dumps({"probes": [probe]}))
    print(json.dumps({"zero_d": zero_d}))
    print(json.dumps({"calibration": calibration}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"activation": activation}))
    print(json.dumps({"tendencies": tendencies}))
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_roof(device, R, packed):
    """Phase 6's kernels (``kernels/roof.py``): K6 and the ``expf`` probe
    against their plain versions bit for bit, then each timed at full size
    on the packed state ``packed`` by CUDA events. Returns K6's record and
    the probe's (without launch counts)."""
    import torch

    from cloudmicrophysics_tpu_torch.kernels.column1m import pack_state
    from cloudmicrophysics_tpu_torch.models.bench_states import device_state

    print("== K6 (copy_scale) and the expf probe (exp_chain) vs their plain "
          "versions, bit for bit")
    bits = [0, 0]    # cases bit-identical to the plain version, of
    err = {"K6": 0.0, "probe": 0.0}

    def hold(key, label, got, ref):
        err[key] = max(err[key], float((got - ref).abs().max()))
        _same(f"{key} {label}", got, ref, bits)

    # the scales as the TPU programs compute them: K6's 1 + 1e-7 i in float32
    # (benchmarks/roofline.py), K6b's and K6c's float32(1 + 1e-6 i)
    # (benchmarks/scratch/perf_roof.py, perf_roof2.py)
    s6 = R.scale_of(3)
    s6b = torch.tensor(1.0 + 1e-6 * 5, dtype=torch.float32)
    small = pack_state(device_state(4096, 128, device, seed=7))
    ragged = pack_state(device_state(1001, 33, device, seed=7))  # numel 4k+3
    offset = ragged.reshape(-1)[1:]    # starts 4 bytes past a 16-byte line
    out_offset = torch.empty(offset.numel() + 1, device=device)[1:]
    cases = [("(7, 4096, 128)", small, s6, None),
             ("ragged (7, 1001, 33)", ragged, s6b, None),
             ("view offset by one element, fresh output", offset, s6, None),
             ("view offset by one element, output offset alike", offset, s6,
              out_offset),
             ("K6c all-ones (7, 4096, 128)", torch.ones_like(small), s6b,
              None),
             (f"full size (7, {NCOL}, {NLEV})", packed, s6, None)]
    for label, x, s, out in cases:
        hold("K6", label, R.copy_step(x, s, out=out), R.copy_step_plain(x, s))
    xe = torch.full((NCOL * NLEV,), 0.5, device=device)
    for label, x, s in (("(7, 4096, 128)", small, 3),
                        ("ragged (7, 1001, 33)", ragged, 5),
                        ("view offset by one element", offset, 7),
                        (f"full size ({NCOL * NLEV},) at 0.5", xe, 1)):
        hold("probe", label, R.exp_chain_step(x, s), R.exp_chain_plain(x, s))
    print(f"  K6 and the probe bit-identical to their plain versions in "
          f"{bits[0]} of {bits[1]} cases")
    if bits[0] != bits[1]:
        raise AssertionError("K6 or the expf probe differs from its plain "
                             "version")
    del small, ragged, offset, out_offset

    print(f"== K6 on ({len(packed)}, {NCOL}, {NLEV}) float32 and the probe on "
          f"{NCOL * NLEV} elements, CUDA events")
    s = R.scale_of(1)
    buf = torch.empty_like(packed)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=device)
    nbytes = 2 * packed.numel() * packed.element_size()   # read + write
    k6_ms = min(_time_ms(lambda: R.copy_step(packed, s, out=buf), reps=10))
    plain_ms = min(_time_ms(lambda: R.copy_step_plain(packed, s), reps=5))
    mul_ms = min(_time_ms(lambda: torch.mul(packed, float(s), out=buf),
                          reps=10))
    add_ms = min(_time_ms(lambda: torch.add(tiny, packed, alpha=float(s),
                                            out=buf), reps=10))
    bound_ms = nbytes / _rates().hbm * 1e3
    for name, ms in (("K6 copy_scale", k6_ms),
                     ("plain x * s + 1e-12 (two passes)", plain_ms),
                     ("torch.mul(packed, s, out=buf)", mul_ms),
                     ("torch.add(1e-12, packed, alpha=s, out=buf)", add_ms)):
        print(f"  {name}: {ms:.6g} ms, {nbytes / ms / 1e6:.6g} GB/s, "
              f"{bound_ms / ms:.4g} of the bytes bound")
    print(f"  K6 bound {bound_ms:.6g} ms ({nbytes} B at "
          f"{_rates().hbm:.6g} B/s); plain/K6 {plain_ms / k6_ms:.4g}, "
          f"torch.add/K6 {add_ms / k6_ms:.4g}")
    del buf

    exp_ms = min(_time_ms(lambda: R.exp_chain_step(xe, 1), reps=10))
    exp_plain_ms = min(_time_ms(lambda: R.exp_chain_plain(xe, 1), reps=3))
    n_exp = xe.numel() * R.CHAIN
    t_mufu = n_exp / _rates().mufu * 1e3
    t_bytes = 2 * xe.numel() * xe.element_size() / _rates().hbm * 1e3
    print(f"  expf probe: {exp_ms:.6g} ms, {n_exp / exp_ms * 1e3:.6g} expf/s "
          f"({R.CHAIN} per element); bound {max(t_mufu, t_bytes):.6g} ms "
          f"(one MUFU per expf at {_rates().mufu:.6g}/s; bytes {t_bytes:.4g} "
          f"ms), {max(t_mufu, t_bytes) / exp_ms:.4g} of it; plain chain "
          f"({2 * R.CHAIN + 1} passes) {exp_plain_ms:.6g} ms")
    if exp_ms < max(t_mufu, t_bytes):
        raise AssertionError("the expf probe ran faster than one MUFU per "
                             "expf allows: its chain was cut")
    csrc = "cloudmicrophysics_tpu_torch/kernels/csrc/roof.cu"
    k6 = {"ms": k6_ms, "plain_ms": plain_ms, "library_ms": add_ms,
          "bound_ms": bound_ms, "max_abs_err": err["K6"], "nbytes": nbytes,
          "source": csrc}
    probe = {"name": "exp_chain (expf probe)", "route": "cuda",
             "source": csrc,
             "replaces": "benchmarks/roofline.py:150 (exp_chain, plain jnp: "
                         "no Pallas kernel)",
             "max_abs_err": err["probe"], "ms": exp_ms,
             "plain_ms": exp_plain_ms, "expf_per_s": n_exp / exp_ms * 1e3,
             "bound_ms": max(t_mufu, t_bytes),
             "bound_by": "operations" if t_mufu >= t_bytes else "bytes",
             "library_ms": None}
    return k6, probe


def _run_roofline(K, K2M, K5, R, timing, mufu):
    """Phase 13: the port's roofline at full width, its launch counters
    read just before and again just after; each of K1-K5 (its time of
    phases 5, 9 and 12, and its MUFU operations per step, ``mufu``) as a
    share of the measured copy roof and of the measured expf rate. Returns
    the launch counts of K6 and the probe."""
    import torch

    from cloudmicrophysics_tpu_torch import roofline

    print(f"== roofline: K6 and the expf probe at ({NCOL}, {NLEV}), K1 and "
          f"K3 at ({NCOL}, {NLEV}), K5 GL-16 at ({P3_NCOL}, {P3_NLEV})")
    counted = {"K6": R.copy_step, "probe": R.exp_chain_step,
               "K1": K.step_column_1m_fused_packed,
               "K3": K2M.step_column_2m_fused_packed,
               "K5": K5.step_column_p3_fused}
    torch.cuda.synchronize()
    base = _launch_counts(counted)
    rows = roofline.main(["--ncol", str(NCOL), "--nlev", str(NLEV),
                          "--p3-ncol", str(P3_NCOL),
                          "--p3-nlev", str(P3_NLEV)])
    launches = _launch_counts(counted, base)
    torch.cuda.synchronize()
    runs = 1 + roofline.REPS * roofline.N_ITER
    want = {k: runs for k in counted}
    want["K5"] = 1 + roofline.REPS * roofline.P3_N_ITER
    print(f"  launches in the roofline: {launches}")
    if launches != want:
        raise AssertionError(f"roofline launch counts {launches} != calls "
                             f"driven {want}")
    row = {r["metric"]: r for r in rows}
    copy_bw = row["dma_copy_roof"]["achieved_GBps"] * 1e9
    exp_rate = row["vpu_exp_rate"]["exp_per_s"]
    print(f"  measured roofs: copy {copy_bw:.6g} B/s "
          f"({row['dma_copy_roof']['fraction_of_hbm_datasheet']:.4g} of the "
          f"data sheet's {_rates().hbm:.6g}), expf {exp_rate:.6g}/s "
          f"({exp_rate / _rates().mufu:.4g} of {_rates().mufu:.6g} MUFU/s)")
    for k, nbytes in (("K1", 14 * 4 * NCOL * NLEV),
                      ("K2", 14 * 4 * NCOL * NLEV),
                      ("K3", 14 * 4 * NCOL * NLEV),
                      ("K4", 14 * 4 * NCOL * NLEV),
                      ("K5", 24 * 4 * P3_NCOL * P3_NLEV)):
        t = timing[k][0] * 1e-3
        print(f"  {k}: {timing[k][0]:.6g} ms/step, "
              f"{nbytes / t / copy_bw:.4g} of the copy roof, "
              f"{mufu[k] / t / exp_rate:.4g} of the expf rate "
              f"({mufu[k]:.6g} MUFU per step)")
    return {"K6": launches["K6"], "probe": launches["probe"]}


def _run_bench_press(device, K, K2M, Column1MStep, Column2MStep,
                     ColumnP3Step, mp, tps, tv, microphysics_2m_params):
    """Phase 14: ``perf.bench_press`` on the three step modules at full
    width, with budgets of about 1.5 times PERF.md's times."""
    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
        p3_bench_state,
    )
    from cloudmicrophysics_tpu_torch.perf import bench_press

    print("== perf harness: bench_press on the step modules at full width")
    model = Column1MStep(mp, tps, tv, DT, DZ, device=device)
    packed = K.pack_state(device_state(NCOL, NLEV, device))
    reports = [bench_press(model, (packed,), 6.0e6, name="Column1MStep (K1)")]
    model = Column2MStep(microphysics_2m_params(), tps, DT, DZ, device=device)
    packed = K2M.pack_state_2m(device_state_2m(NCOL, NLEV, device))
    reports.append(bench_press(model, (packed,), 6.3e6,
                               name="Column2MStep (K3)"))
    del packed
    model = ColumnP3Step(microphysics_2m_params(with_ice=True), tps, DT, DZ,
                         device=device)
    state = p3_bench_state(P3_NCOL, P3_NLEV, device)
    _, guess = model(state)
    reports.append(bench_press(model, (state, guess), 47e6,
                               name="ColumnP3Step GL-16, warm (K5)"))
    for r in reports:
        print(f"  {r.name}: best {r.best_ns / 1e6:.6g} ms, budget "
              f"{r.budget_ns / 1e6:.6g} ms, n_traces {r.n_traces}, ok {r.ok}")


def _run_2m(device, K, Column2MStep, microphysics_2m_params, tps, copy_ms):
    """Phases 7-9: the 2M warm-rain kernels K3 (packed) and K4 (unpacked)
    against their plain versions, and the 2M path at full width. Returns
    the launch counts of the main path, the largest errors and the
    (kernel, plain) times."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state_2m,
        uniform_state_2m,
    )

    mp = microphysics_2m_params()
    fused, packed_fused = K.step_column_2m_fused, K.step_column_2m_fused_packed

    # ---- 7. kernel parity on the card --------------------------------------
    print(f"== 2M kernels vs plain version (rtol {RTOL}, atol {ATOL})")
    max_err = {"K3": 0.0, "K4": 0.0}
    bits = [0, 0]    # K3/K4 comparisons bit-identical to the plain step, of
    opts = dict(BLOCKS_2M)
    cases = [
        ("(4096, 128)", "default", 4096, 128, (256, 128), None, False),
        ("ragged (1000, 40)", "default", 1000, 40, (8, 40), None, False),
        ("(64, 512)", "default", 64, 512, (16, 64), None, False),
        # the 2m_fields cell: 8 columns of 100 levels a warp, 25 windows
        # that cross columns; then uneven ranges at 100 levels, 13 and 12
        # columns a warp at 200 a block, 3 and 2 at 40
        ("2m_fields cell (1048576, 100)", "default", 1048576, 100,
         (128, 16), None, False),
        ("uneven (1000, 100)", "default", 1000, 100, (200, 40), None, False),
        ("affine (4096, 128)", "default", 4096, 128, (128, 64), AFFINE,
         False),
        ("is_limited=False", "is_limited=False", 4096, 128, (256, 64), None,
         False),
        ("rain_velocity=chen2022", "rain_velocity=chen2022", 4096, 128,
         (256, 64), None, False),
        ("uniform bench state", "default", 4096, 128, (256, 128), None, True),
    ]
    for label, block, ncol, nlev, tilings, affine, uniform in cases:
        mpc = microphysics_2m_params(**opts[block])
        params = K.kernel_params_2m(mpc, tps)
        st = (uniform_state_2m(ncol, nlev, device) if uniform
              else device_state_2m(ncol, nlev, device, seed=7))
        if affine is None:   # K4 has no affine, as the Pallas kernel
            ref = K.step_column_2m_plain(st, mpc, tps, DT, DZ)
            outs = [fused(st, mpc, tps, DT, DZ, block_cols=bc, params=params)
                    for bc in tilings]
            max_err["K4"] = max(max_err["K4"], _report(
                f"K4 {label} block_cols={tilings[0]}", _compare(outs[0], ref)))
            _same(f"K4 {label}", outs[0], ref, bits)
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"K4 {label}: block_cols {tilings} differ")
            print(f"  K4 {label}: block_cols {tilings} agree bit for bit")
        pk = K.pack_state_2m(st)
        pref = K.unpack_state_2m(K.step_column_2m_packed_plain(
            pk, mpc, tps, DT, DZ, q_tot_affine=affine))
        pouts = [packed_fused(pk, mpc, tps, DT, DZ, block_cols=bc,
                              q_tot_affine=affine, params=params)
                 for bc in tilings]
        max_err["K3"] = max(max_err["K3"], _report(
            f"K3 {label} block_cols={tilings[0]}",
            _compare(K.unpack_state_2m(pouts[0]), pref)))
        _same(f"K3 {label}", K.unpack_state_2m(pouts[0]), pref, bits)
        if not torch.equal(pouts[0], pouts[1]):
            raise AssertionError(f"K3 {label}: block_cols {tilings} differ")
        print(f"  K3 {label}: block_cols {tilings} agree bit for bit")
    print(f"  K3/K4 bit-identical to the plain step in {bits[0]} of {bits[1]} "
          f"comparisons")
    if bits[0] != bits[1]:
        raise AssertionError("K3/K4 differ from the plain step")
    del st, pk, pref, pouts

    # ---- 8. the 2M path at full width --------------------------------------
    print(f"== 2M path: Column2MStep on ({NCOL}, {NLEV}) float32, "
          f"{N_ROLLOUTS} x {N_STEPS} steps")
    state = device_state_2m(NCOL, NLEV, device)
    model = Column2MStep(mp, tps, DT, DZ, device=device)
    first, packed, launches = _drive(model, state, K.pack_state_2m,
                                     K.unpack_state_2m, fused, packed_fused,
                                     ("K3", "K4"))
    ref = K.step_column_2m_plain(state, mp, tps, DT, DZ)
    max_err["K4"] = max(max_err["K4"], _report(
        "K4 2M path's full-size step vs plain", _compare(first, ref)))
    if not _same("K4 2M path's full-size step", first, ref, bits):
        raise AssertionError("K4 full-size step differs from the plain step")
    del first, ref

    # ---- 9. kernels and plain versions at full size ------------------------
    print(f"== 2M kernels vs plain version at ({NCOL}, {NLEV}), CUDA events")
    torch.cuda.reset_peak_memory_stats(device)
    plain4 = _time_ms(lambda: K.step_column_2m_plain(
        state, mp, tps, DT, DZ), reps=3)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    kern4 = _time_ms(lambda: fused(state, mp, tps, DT, DZ,
                                   params=model.params), reps=10)
    kern3 = _time_ms(lambda: model(packed, q_tot_affine=AFFINE), reps=10)
    plain3 = _time_ms(lambda: K.step_column_2m_packed_plain(
        packed, mp, tps, DT, DZ, q_tot_affine=AFFINE), reps=3)
    timing = {"K3": (min(kern3), min(plain3)), "K4": (min(kern4), min(plain4))}
    for k, (t_kern, t_plain) in timing.items():
        print(f"  {k}: kernel {t_kern:.6g} ms/step, plain {t_plain:.6g} "
              f"ms/step, plain/kernel {t_plain / t_kern:.4g}")
    print(f"  plain version peak device memory {peak_gb:.4g} GB")
    out = K.unpack_state_2m(model(packed, q_tot_affine=AFFINE))
    ref = K.unpack_state_2m(K.step_column_2m_packed_plain(
        packed, mp, tps, DT, DZ, q_tot_affine=AFFINE))
    max_err["K3"] = max(max_err["K3"], _report(
        "K3 one full-size step vs plain", _compare(out, ref)))
    if not _same("K3 one full-size step", out, ref, bits):
        raise AssertionError("K3 full-size step differs from the plain step")
    del out, ref
    _stages("K3", K, K._library(model.params, K._variant(mp), "probe"),
            packed, "warp windows of 32 cells", slots="k3.lane_slots")
    nbytes = 2 * packed.numel() * packed.element_size()   # read + write
    print(f"  K3: {timing['K3'][0]:.6g} ms/step, "
          f"{nbytes / timing['K3'][0] / 1e6:.6g} GB/s, "
          f"{copy_ms / timing['K3'][0]:.4g} of K6's rate")
    n_plain = _device_kernels(lambda: K.step_column_2m_packed_plain(
        packed, mp, tps, DT, DZ, q_tot_affine=AFFINE))
    print(f"  plain packed step: {n_plain} device kernels per step "
          f"(torch.profiler)")
    idle = _idle_share(lambda: model(packed, q_tot_affine=AFFINE), calls=10)
    print("  device idle share over 10 K3 steps (torch.profiler): "
          + ("not measured, the profiler saw no device time" if idle is None
             else f"{idle:.6g}"))
    return launches, max_err, timing


# ---------------------------------------------------------------------------
# The 2M + P3 path (phases 10-12)
# ---------------------------------------------------------------------------

P3_NCOL, P3_NLEV = 16384, 128   # the repo's P3 size (BENCH_SUITE.json batch)
P3_STEPS, P3_ROLLOUTS = 10, 3   # the P3 bench's n_iter, and three rollouts
P3_LL_RTOL, P3_RTOL, P3_ATOL = 2e-5, 3e-5, 1e-10   # tests/test_kernels.py:192
P3_CHUNKS = 16                  # column chunks of the plain full-size step
P3_ORDERS = (4, 8, 16)          # the Gauss-Legendre orders of phases 10-11
RECORD = "cloudmicrophysics_tpu_torch/data/p3_ladder_gl16.json"


def _p3_state(arrays, device):
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

    return ColumnStateP3(*(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                           for a in arrays))


def _p3_mixed_state(ncol, nlev, device, seed=0):
    """Cells without ice, with unrimed, rimed, heavily rimed and tiny ice,
    warm and cold (290 -> 225 K): ice below freezing only, cloud above
    245 K, rain above 263 K (where the Bigg freezing rate stays moderate)."""
    rng = np.random.default_rng(seed)
    sh = (ncol, nlev)
    ones = np.ones((ncol, 1))
    rho = np.linspace(1.2, 0.4, nlev)[None] * ones
    T = np.linspace(290.0, 225.0, nlev)[None] * ones \
        + rng.uniform(-2.0, 2.0, (ncol, 1))
    kind = rng.integers(0, 5, sh)
    cold = T < 273.15
    q_ice = np.where(cold & (kind > 0), 10 ** rng.uniform(-6, -3, sh), 0.0)
    q_ice = np.where(cold & (kind == 4), 10 ** rng.uniform(-8, -6, sh), q_ice)
    n_ice = np.where(q_ice > 0, q_ice / 10 ** rng.uniform(-11, -7.5, sh), 0.0)
    frac = np.select([kind == 2, kind == 3, kind == 4],
                     [rng.uniform(0.05, 0.6, sh), rng.uniform(0.8, 0.99, sh),
                      rng.uniform(0.0, 0.5, sh)], 0.0)
    q_rim = q_ice * frac
    b_rim = q_rim / rng.uniform(100.0, 900.0, sh)
    q_lcl = np.where((T > 245.0) & (rng.random(sh) < 0.7),
                     1e-3 * rng.random(sh), 0.0)
    n_lcl = np.where(q_lcl > 0, 1e8 * (0.1 + rng.random(sh)), 0.0)
    q_rai = np.where((T > 263.0) & (rng.random(sh) < 0.7),
                     5e-4 * rng.random(sh), 0.0)
    n_rai = np.where(q_rai > 0, 1e6 * (0.05 + rng.random(sh)), 0.0)
    q_tot = q_lcl + q_rai + q_ice \
        + 8e-3 * rng.random(sh) * np.clip((T - 215.0) / 75.0, 0.05, 1.0)
    return _p3_state([rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai, q_ice,
                      n_ice, q_rim, b_rim], device)


def _p3_ladder_state(states, nrep, nlev, device):
    """The curated states, each repeated over ``nrep`` columns of ``nlev``
    levels, with a +-5 % rho and +-2 K T profile over the levels."""
    rows = np.asarray(states, dtype=np.float64)
    arr = np.repeat(rows[:, None, :], nrep, axis=1).reshape(-1, 11)
    arr = np.repeat(arr[:, None, :], nlev, axis=1)
    arr[..., 0] *= np.linspace(1.05, 0.95, nlev)[None, :]
    arr[..., 1] += np.linspace(2.0, -2.0, nlev)[None, :]
    return _p3_state([arr[..., i] for i in range(11)], device)


def _compare_p3(label, out, loglam, ref, ref_loglam):
    """Hold a K5 result against the plain version: log lambda rtol 2e-5
    (infinities where the plain step has them), every field rtol 3e-5 /
    atol 1e-10 and finite. Prints per-field errors; returns the largest
    absolute error."""
    import torch

    fin = torch.isfinite(ref_loglam)
    ll_ok = bool(torch.equal(torch.isinf(loglam), torch.isinf(ref_loglam))) \
        and not bool(torch.isnan(loglam).any())
    d = (loglam - ref_loglam).abs()[fin]
    ll_rel = float((d / ref_loglam.abs()[fin]).max()) if d.numel() else 0.0
    ll_ok = ll_ok and ll_rel <= P3_LL_RTOL
    rows, bad = [], ["loglam"] if not ll_ok else []
    worst = float(d.max()) if d.numel() else 0.0
    for name, a, b in zip(ref._fields, out, ref):
        e = (a - b).abs()
        ok = bool((e <= P3_ATOL + P3_RTOL * b.abs()).all()) \
            and bool(a.isfinite().all())
        rel = float((e / b.abs().clamp(min=1e-30)).max())
        rows.append(f"{name} {float(e.max()):.2e}/{rel:.2e}")
        worst = max(worst, float(e.max()))
        if not ok:
            bad.append(name)
    print(f"  {label}: loglam rel {ll_rel:.2e}, " + ", ".join(rows))
    if bad:
        raise AssertionError(f"{label}: K5 disagrees with the plain version "
                             f"in {bad}")
    return worst


def _run_p3(device, K, ColumnP3Step, microphysics_2m_params, tps, copy_gbs,
            attrs):
    """Phases 10-12: the 2M + P3 step K5 (kernels K5a, K5b, K5c) against
    its plain version, the P3 path at full width, the timings and the
    operation count. Returns the launch counts of the main path, the
    largest error, the (kernel, plain) times and K5's bound and kernels."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import p3_bench_state

    fused = K.step_column_p3_fused
    record = json.loads(
        (Path(__file__).resolve().parent / RECORD).read_text())

    # ---- 10. kernel parity on the card -------------------------------------
    print(f"== 2M + P3 kernel vs plain version (log lambda rtol "
          f"{P3_LL_RTOL}, fields rtol {P3_RTOL}, atol {P3_ATOL})")
    max_err = 0.0
    cases = [
        ("ladder (640, 16)", _p3_ladder_state(record["states"], 64, 16,
                                              device), (128, 10)),
        ("mixed (4096, 64)", _p3_mixed_state(4096, 64, device, seed=3),
         (128, 2)),
        ("ragged (1000, 40)", _p3_mixed_state(1000, 40, device, seed=5),
         (8, 40)),
    ]
    # K5a alone first: the fixed-trip Brent stops elsewhere on a last-bit
    # change of its residual
    ladder = cases[0][1]
    mp_solve = microphysics_2m_params(with_ice=True, quadrature_order=16)
    ll_plain = K.loglambda_p3_plain(ladder, mp_solve)
    away = torch.where(torch.isfinite(ll_plain), ll_plain + 0.25, ll_plain)
    for start, guess in (("cold", None), ("warm, guess off the root", away),
                         ("warm, guess at the root", ll_plain)):
        got = K.loglambda_p3_fused(ladder, mp_solve, tps, guess)
        want = (ll_plain if guess is None
                else K.loglambda_p3_plain(ladder, mp_solve, guess))
        fin = torch.isfinite(want)
        rel = float(((got - want).abs()[fin] / want.abs()[fin]).max())
        same = torch.equal(got, want)
        print(f"  K5a log lambda, ladder (640, 16) {start}: "
              + ("bit-identical to the plain solve" if same
                 else f"max rel diff {rel:.3e} from the plain solve"))
        if not same and not (torch.equal(torch.isinf(got), torch.isinf(want))
                             and rel <= P3_LL_RTOL):
            raise AssertionError(f"K5a log lambda ({start}) disagrees with "
                                 f"the plain solve")
    n_cases = n_bit = 0
    runs = [(order, {}) for order in P3_ORDERS] + [
        (8, {"is_limited": False, "rain_velocity": "chen2022"})]
    for order, opts in runs:
        mp = microphysics_2m_params(with_ice=True, quadrature_order=order,
                                    **opts)
        params = K.kernel_params_p3(mp, tps, device=device)
        tag = f"GL-{order}" + (f" {opts}" if opts else "")
        for label, st, tilings in cases:
            ref, ref_ll = K.step_column_p3_plain(st, mp, tps, DT, DZ)
            for start, guess, ref_out in (("cold", None, (ref, ref_ll)),
                                          ("warm", ref_ll, None)):
                st_in = st if guess is None else ref
                if ref_out is None:
                    ref_out = K.step_column_p3_plain(st_in, mp, tps, DT, DZ,
                                                     guess)
                outs = [fused(st_in, mp, tps, DT, DZ, guess, block_cols=bc,
                              params=params) for bc in tilings]
                max_err = max(max_err, _compare_p3(
                    f"K5 {tag} {label} {start}", outs[0][0], outs[0][1],
                    ref_out[0], ref_out[1]))
                (a, la), (b, lb) = outs
                n_cases += 1
                n_bit += torch.equal(la, ref_out[1]) and all(
                    torch.equal(x, y) for x, y in zip(a, ref_out[0]))
                if not (all(torch.equal(x, y) for x, y in zip(a, b))
                        and torch.equal(la, lb)):
                    raise AssertionError(f"K5 {tag} {label} {start}: "
                                         f"block_cols {tilings} differ")
        print(f"  K5 {tag}: every case's tilings agree bit for bit")
    print(f"  K5 bit-identical to the plain step (log lambda and every "
          f"field) in {n_bit} of {n_cases} comparisons")
    del cases, outs, ref, ref_out

    print("== K5 float32 against the JAX package's float64 step "
          f"({RECORD})")
    mp16 = microphysics_2m_params(with_ice=True,
                                  quadrature_order=record["quadrature_order"])
    cols = np.asarray(record["states"], dtype=np.float64).T
    st = _p3_state([c[:, None] for c in cols], device)
    out, ll = fused(st, mp16, tps, record["dt"], record["dz"], block_cols=10)
    n_nan = 0
    for name, x in zip(out._fields, out):
        want = np.asarray(record["step"][name])
        got = x[:, 0].double().cpu().numpy()
        n_nan += int(np.isnan(got).sum())
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        print(f"  {name}: max rel err {float(rel.max()):.3e}, "
              f"NaN {int(np.isnan(got).sum())}")
    want = np.asarray(record["loglambda"])
    got = ll[:, 0].double().cpu().numpy()
    fin = np.isfinite(want)
    n_nan += int(np.isnan(got).sum())
    print(f"  loglam: max rel err "
          f"{float((np.abs(got[fin] - want[fin]) / np.abs(want[fin])).max()):.3e},"
          f" NaN {int(np.isnan(got).sum())}, -inf where the reference has it:"
          f" {bool((np.isneginf(got) == np.isneginf(want)).all())}")
    if n_nan:
        raise AssertionError(f"K5 float32 step on the ladder states: {n_nan} "
                             f"NaN")

    # ---- 11. the P3 path at full width -------------------------------------
    print(f"== P3 path: ColumnP3Step on ({P3_NCOL}, {P3_NLEV}) float32 "
          f"GL-16, 1 cold step + {P3_ROLLOUTS} x {P3_STEPS} warm-started "
          f"steps")
    state = p3_bench_state(P3_NCOL, P3_NLEV, device)
    model = ColumnP3Step(mp16, tps, DT, DZ, device=device)
    first, first_ll, launches, ms = _drive_p3(model, state, K, "GL-16")
    ref, ref_ll = K.step_column_p3_plain(state, mp16, tps, DT, DZ,
                                         col_chunks=P3_CHUNKS)
    max_err = max(max_err, _compare_p3("K5 P3 path's full-size cold step "
                                       "vs plain", first, first_ll, ref,
                                       ref_ll))
    del ref, ref_ll
    mp8 = microphysics_2m_params(with_ice=True, quadrature_order=8)
    model8 = ColumnP3Step(mp8, tps, DT, DZ, device=device)
    _drive_p3(model8, state, K, "GL-8", rollouts=1)

    # ---- 12. kernel and plain version at full size -------------------------
    print(f"== K5 vs plain version at ({P3_NCOL}, {P3_NLEV}) GL-16, CUDA "
          f"events")
    kern = _time_ms(lambda: model(state, first_ll), reps=5)
    idle = _idle_share(lambda: model(state, first_ll), calls=10)
    torch.cuda.reset_peak_memory_stats(device)
    plain = _time_ms(lambda: K.step_column_p3_plain(
        state, mp16, tps, DT, DZ, first_ll, col_chunks=P3_CHUNKS), reps=1,
        warmup=0)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    timing = {"K5": (min(kern), min(plain))}
    print(f"  K5: kernel {min(kern):.6g} ms/step (per call "
          f"{[round(t, 6) for t in kern]}), plain {min(plain):.6g} ms/step "
          f"(one call, {P3_CHUNKS} column chunks), plain/kernel "
          f"{min(plain) / min(kern):.4g}")
    print(f"  plain version peak device memory {peak_gb:.4g} GB")
    # every chunk runs the same program: count one chunk's device kernels
    rows = P3_NCOL // P3_CHUNKS
    chunk = type(state)(*(t[:rows] for t in state))
    n_chunk = _device_kernels(lambda: K.step_column_p3_plain(
        chunk, mp16, tps, DT, DZ, first_ll[:rows]))
    print(f"  plain step: {n_chunk} device kernels per column chunk "
          f"(torch.profiler), "
          + ("not measured" if n_chunk is None
             else f"{n_chunk * P3_CHUNKS} per step"))
    nbytes = 24 * 4 * P3_NCOL * P3_NLEV   # 12 fields read, 12 written
    rate = nbytes / min(kern) / 1e6
    print(f"  K5: {min(kern):.6g} ms/step, {rate:.6g} GB/s, "
          f"{rate / copy_gbs:.4g} of K6's rate "
          f"({copy_gbs:.6g} GB/s)")
    print("  device idle share over 10 K5 steps (torch.profiler): "
          + ("not measured, the profiler saw no device time" if idle is None
             else f"{idle:.6g}"))
    kern8 = _time_ms(lambda: model8(state, first_ll), reps=5)
    print(f"  K5 GL-8: {min(kern8):.6g} ms/step (per call "
          f"{[round(t, 6) for t in kern8]})")
    del model8

    # ---- K5's three kernels: times, operations, bound ---------------------
    parts = _k5_parts(K, model, state, first_ll, device)
    ops, every_arm, warp_issued = _k5_ops(K, model, state, first_ll, device)
    total = ops["K5a"] + ops["K5b"] + ops["K5c"]
    bound_ms, bound_by = _bound(nbytes, total)
    cells = P3_NCOL * P3_NLEV
    print(f"  K5 GL-16 per cell: {total.flops / cells:.6g} float32 "
          f"operations, {total.mufu / cells:.6g} MUFU, "
          f"{total.issued / cells:.6g} instructions issued "
          f"({sum(every_arm.values()) / cells:.6g} with every arm); bound "
          f"{bound_ms:.6g} ms ({bound_by}; bytes "
          f"{nbytes / _rates().hbm * 1e3:.4g} ms, float32 "
          f"{total.flops / _rates().fp32 * 1e3:.4g} ms, MUFU "
          f"{total.mufu / _rates().mufu * 1e3:.4g} ms), K5 {min(kern):.6g} "
          f"ms/step = {bound_ms / min(kern):.4g} of the bound")
    subkernels = []
    for key, fn in (("K5a", "column_p3_solve"), ("K5b", "column_p3_nodes"),
                    ("K5c", "column_p3_epilogue")):
        b = _ops_ms(ops[key])
        issued = warp_issued[key] / _rates().warp_issue * 1e3
        a = attrs[16][key]
        print(f"  {key}: {parts[key]:.6g} ms/step; per cell "
              f"{ops[key].flops / cells:.6g} float32 operations, "
              f"{ops[key].mufu / cells:.6g} MUFU, "
              f"{ops[key].issued / cells:.6g} instructions issued "
              f"({every_arm[key] / cells:.6g} with every arm); bound "
              f"{b:.6g} ms, {b / parts[key]:.4g} of it; its "
              f"{warp_issued[key]:.6g} warp instructions (divergence "
              f"included) take {issued:.6g} ms to issue, {issued / parts[key]:.4g}"
              f" of its time; {a['registers']} registers, {a['local_bytes']} B "
              f"local" + (" (above 1: the count attributes too much)"
                          if issued > parts[key] else ""))
        subkernels.append({
            "name": f"{fn}_kernel ({key})",
            "launches": launches[key], "ms": parts[key],
            "float32_ops": ops[key].flops, "mufu_ops": ops[key].mufu,
            "instructions": ops[key].issued, "bound_ms": b,
            "registers": a["registers"], "local_bytes": a["local_bytes"]})
    print(f"  sum of the three kernels {sum(parts.values()):.6g} ms, whole "
          f"step {min(kern):.6g} ms")
    return ({"K5": launches["K5"]}, {"K5": max_err}, timing,
            {"bound_ms": bound_ms, "bound_by": bound_by,
             "mufu_ops": total.mufu, "subkernels": subkernels})


def _k5_launches(K, model, state, guess, device, lib):
    """K5a, K5b and K5c of ``model``'s build (``lib``, the kernel or the
    probe) on ``state`` as three calls, with their own outputs and scratch
    record."""
    import torch

    from cloudmicrophysics_tpu_torch.kernels import _build

    mp, dtype = model.mp, state.rho.dtype
    ncol, nlev = state.rho.shape
    plan = K.launch_plan(ncol, nlev, mp.ice.quad.n,
                         _build.fit_block_cols(ncol, K.BLOCK_COLS), dtype)
    params = model.block(dtype)
    scratch = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
    loglam = torch.empty_like(state.rho)
    out = type(state)(*(torch.empty_like(t) for t in state))
    warm = K.warm_variant(mp)
    calls = {
        "K5a": lambda: K.launch_solve(lib, state, guess, loglam, scratch,
                                      params, plan, device),
        "K5b": lambda: K.launch_nodes(lib, state, scratch, params, plan,
                                      device),
        "K5c": lambda: K.launch_epilogue(lib, state, out, scratch, params,
                                         plan, DT, DZ, warm, device),
    }
    return calls, plan, loglam


def _k5_parts(K, model, state, guess, device, reps=5):
    """ms of each of K5's kernels alone on ``state`` (the build of
    ``model`` and the state's dtype) by CUDA events (best of ``reps``),
    with ``nvidia-smi`` sampling the SM clock and power beside them."""
    v = K.variant(model.mp, state.rho.dtype)
    calls, _, _ = _k5_launches(K, model, state, guess, device,
                               K._library("kernel", v))
    for fn in calls.values():
        fn()
    times, clock = _with_sm_clock(
        lambda: {k: min(_time_ms(fn, reps=reps)) for k, fn in calls.items()})
    print(f"  K5 kernels alone, {v.tag()} {tuple(state.rho.shape)}: "
          + ", ".join(f"{k} {t:.6g} ms" for k, t in times.items())
          + f"; {clock}")
    return times


def _k5_ops(K, model, state, guess, device, quiet=False):
    """Operations K5a, K5b and K5c run on ``state`` (the build of ``model``
    and the state's dtype): the probe build's per-region executions times
    each region's operations on its least path through the timed build's
    SASS (kernels/opcount.py). Returns per kernel the
    :class:`opcount.Tally`, the instructions with every arm counted, and
    the warp instructions issued; writes the SASS and the probe's counts to
    ``kernels/build/`` (the default build's as ``column_p3.*``, another
    variant's with its tag in the name)."""
    import gzip

    import torch

    from cloudmicrophysics_tpu_torch.kernels import _build, opcount

    v = K.variant(model.mp, state.rho.dtype)
    src = (_build.CSRC_DIR / K.SOURCE).read_text()
    names = opcount.region_names(src)
    sites = opcount.probe_sites(src, K.probe_unrolls(v))
    if set(names) != set(sites):
        raise AssertionError(f"regions without one K5_COUNT site: "
                             f"{sorted(set(names) ^ set(sites))}")
    plib = K._library("probe", v)
    if plib.column_p3_probe_regions() != len(names):
        raise AssertionError("probe build with another region list")
    calls, plan, loglam = _k5_launches(K, model, state, guess, device, plib)
    counts, warps = {}, {}
    threads = {"K5a": plan.solve_grid * K.SOLVE_THREADS,
               "K5b": plan.nodes_grid * K.NODE_THREADS,
               "K5c": plan.epilogue_grid * plan.epilogue_block}
    for key, fn in calls.items():
        # rows: each region's thread executions, then its warp executions
        buf = torch.zeros((2 * len(names), threads[key]), dtype=torch.int32,
                          device=device)
        err = plib.column_p3_probe_set(buf.data_ptr(), threads[key],
                                       device.index)
        if err:
            raise RuntimeError(f"column_p3_probe_set: CUDA error {err}")
        fn()
        sums = buf.sum(dim=1, dtype=torch.int64).tolist()
        counts[key] = dict(zip(names, sums[:len(names)]))
        warps[key] = dict(zip(names, sums[len(names):]))
        del buf
    same = torch.equal(loglam, model(state, guess)[1])
    # K5b's lane passes: each cell's lanes run the launch plan's passes
    node_cells = plan.nodes_grid * plan.cells_per_block
    per_cell = counts["K5b"]["R_NODE"] / node_cells
    want = plan.node_passes * plan.lanes_per_cell
    print(f"  K5b R_NODE, {v.tag()}: {counts['K5b']['R_NODE']} thread "
          f"executions, {per_cell:g} a cell; node_passes x lanes "
          f"{plan.node_passes} x {plan.lanes_per_cell} = {want}, for "
          f"{plan.ice_nodes} ice nodes")
    if per_cell != want:
        raise AssertionError(f"K5b {v.tag()}: R_NODE {per_cell:g} a cell, "
                             f"not node_passes x lanes {want}")
    sass = opcount.disassemble(K.library_path("kernel", v))
    stem = "column_p3" + ("" if v == K.DEFAULT_VARIANT else
                          "-" + v.tag().replace(" ", "_"))
    (_build.BUILD_DIR / f"{stem}.sass.gz").write_bytes(
        gzip.compress(sass.encode()))
    (_build.BUILD_DIR / f"{stem}_probe_counts.json").write_text(
        json.dumps({"threads": counts, "warps": warps}))
    limited, chen = K.warm_variant(model.mp)
    tall = int(plan.epilogue_levels < state.rho.shape[1])
    instrs = [i for i in opcount.parse_sass(sass)
              if "epilogue_kernel" not in i.function
              or f"ILb{limited}ELb{chen}ELb{tall}E" in i.function]
    per, static, copies, lost = opcount.region_tallies(instrs, sites,
                                                       K.SOURCE)
    print(f"  K5 operation count, {v.tag()}: {len(instrs)} SASS "
          f"instructions of the timed build (the launched variants), {lost} "
          f"of them in slow-path subroutines or outside every counted "
          f"region; probe run's log lambda equal to the timed build's: "
          f"{same}")
    if not quiet:
        print("    region: instructions per copy on the least path (with "
              "every arm) x copies, float32 operations and MUFU per copy, "
              "thread executions (unroll), instructions run, SIMT "
              "efficiency (thread executions / 32 x warp executions)")
    ops, every_arm, warp_issued = {}, {}, {}
    for key, c in counts.items():
        dyn = opcount.dynamic_count(per, c, sites)
        ops[key] = sum(dyn.values(), opcount.Tally())
        every_arm[key] = sum(static[n] * c[n] / sites[n].unroll
                             for n in names)
        warp_issued[key] = sum(t.issued for t in opcount.dynamic_count(
            per, warps[key], sites).values())
        for n in names:
            if c[n] and not quiet:
                print(f"    {key} {n}: {per[n].issued:.6g} ({static[n]:.6g}) "
                      f"x {copies[n]}, {per[n].flops:.6g}, {per[n].mufu:.6g}, "
                      f"{c[n]} ({sites[n].unroll}), {dyn[n].issued:.6g}, "
                      f"{c[n] / (32 * warps[key][n]):.4g}")
    # an odd number of one branch's incomplete gammas in a residual runs a
    # duplicate chain in the pair loop: work that the data does not need
    c = counts["K5a"]
    dyn = opcount.dynamic_count(per, c, sites)
    dup = opcount.Tally()
    for arm in ("R_GI_SERIES2", "R_GI_CF2"):
        if c[arm]:
            pair = (dyn[arm] + dyn[arm + "_IT"]).scale(1.0 / c[arm])
            dup = dup + pair.scale(c[arm + "_DUP"] / 2)
    print(f"    K5a duplicate chains: {c['R_GI_SERIES2_DUP']} series, "
          f"{c['R_GI_CF2_DUP']} continued fraction, {dup.flops:.6g} float32 "
          f"and {dup.fp64:.6g} float64 operations and {dup.mufu:.6g} MUFU, "
          f"not counted as K5a's work")
    ops["K5a"] = ops["K5a"] + dup.scale(-1.0)
    return ops, every_arm, warp_issued


def _drive_p3(model, state, K, tag, rollouts=P3_ROLLOUTS, nsteps=P3_STEPS):
    """A P3 path at full width: one cold step of ``model`` on ``state``,
    then ``rollouts`` timed rollouts of ``nsteps`` steps, each starting
    from a rollout-distinct copy of ``state`` and the cold step's log
    lambda, carrying log lambda as the next step's guess. The launch
    counters (the step's and each of its three kernels') are read just
    before and again just after; checks that each equals the steps driven,
    that the results are finite and non-negative, and that q_rim <= q_ice.
    Returns the cold step, its log lambda, the launch counts and the
    ms/step of each rollout."""
    import torch

    counted = {"K5": K.step_column_p3_fused, "K5a": K.launch_solve,
               "K5b": K.launch_nodes, "K5c": K.launch_epilogue}
    torch.cuda.synchronize()
    base = _launch_counts(counted)
    first, first_ll = model(state)
    steps = 1
    times, checksums, ends = [], [], []
    for rep in range(rollouts):
        s = type(state)(*(t * (1.0 + 1e-5 * rep) for t in state))
        ll = first_ll
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(nsteps):
            s, ll = model(s, ll)
        end.record()
        end.synchronize()
        steps += nsteps
        times.append(start.elapsed_time(end))
        checksums.append(float(s.q_ice.double().sum()))
        ends.append((s, ll))
    launches = _launch_counts(counted, base)
    torch.cuda.synchronize()
    if set(launches.values()) != {steps}:
        raise AssertionError(f"{tag}: launch counts {launches} != steps "
                             f"driven ({steps})")
    for name, (x, ll) in zip(["cold step"] + [f"rollout {r} end" for r in
                                             range(rollouts)],
                             [(first, first_ll)] + ends):
        for f, v in zip(x._fields, x):
            if v.shape != state.rho.shape or not bool(v.isfinite().all()):
                raise AssertionError(f"{tag} {name}: {f} not finite or "
                                     f"misshapen")
            if f.startswith(("q_", "n_", "b_")) and bool((v < 0).any()):
                raise AssertionError(f"{tag} {name}: {f} negative")
        if bool((x.q_rim > x.q_ice).any()):
            raise AssertionError(f"{tag} {name}: q_rim > q_ice")
        if bool(torch.isnan(ll).any()) or bool(torch.isposinf(ll).any()):
            raise AssertionError(f"{tag} {name}: log lambda NaN or +inf")
    ms = [t / nsteps for t in times]
    pts = [state.rho.numel() / (m * 1e-3) for m in ms]
    print(f"  {tag} ms/step: best {min(ms):.6g}, median "
          f"{float(np.median(ms)):.6g} (per rollout {[round(m, 6) for m in ms]})")
    print(f"  {tag} grid-points/s: best {max(pts):.6g}, median "
          f"{float(np.median(pts)):.6g}")
    print(f"  {tag} checksum sum(q_ice) per rollout: {checksums}")
    print(f"  {tag} launches in this path: {launches} (each = {steps} "
          f"steps: 1 cold + {rollouts} x {nsteps})")
    return first, first_ll, launches, ms

# ---------------------------------------------------------------------------
# The 0-D drivers and the point-wise processes (phase 15)
# ---------------------------------------------------------------------------

PARCEL_STEPS = 1000     # benchmarks/bench_suite.py:229-242
ENSEMBLE = 16384        # the P3 cell's column count, one parcel per column
TULLY_STEPS = 3000      # of the 18000 of examples/parcel_tully_2023.py's
                        # first period: its trajectory would hold ~12 GB
# float32 against float64 on the card (PERF.md §4 gives the reasons):
TOL_DBZ = 1e-3          # reflectivity, absolute dBZ (2M: where every input
                        # is above the float32 presence thresholds)
TOL_REFF = 1e-4         # effective radius, relative, there too
TOL_ACT = 1e-4          # activated number, relative
TOL_HET = 5e-3          # het_ice_nucleation, relative, where float32 holds J
TOL_BOX = 2e-3          # deterministic box frozen fraction, absolute
TOL_BOX_STOCH = 0.08    # stochastic box mean frozen fraction: 5 binomial
                        # sigma at p = 0.5, 1000 droplets
TOL_SANDBOX = 1e-6      # P3 sandbox N_ice and thresholds, relative


def _kernel_stats(fn):
    """(device kernels, the union of their spans in ms, the span from the
    first kernel's start to the last one's end in ms) of one call of ``fn``,
    by ``torch.profiler``; None when it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset")))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + (hi - lo), a
        hi = max(hi, b)
    busy += hi - lo
    return len(spans), busy / 1e3, (hi - spans[0][0]) / 1e3


def _check_parcel(tag, traj):
    """Every field finite, the contents and numbers non-negative."""
    for name, v in zip(traj._fields, traj):
        if not bool(v.isfinite().all()):
            raise AssertionError(f"{tag}: {name} not finite")
        if name.startswith(("q_", "N_")) and bool((v < 0).any()):
            raise AssertionError(f"{tag}: {name} negative "
                                 f"(min {float(v.min()):.3e})")


def _event_ms(fn):
    """Milliseconds of one call of ``fn`` by CUDA events, and its result."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _parcel_bench(device, PM):
    """The TPU benchmark's parcel: one float32 parcel, condensation only,
    dt 0.1 s, w 1 m/s, 1000 steps, the trajectory's final state seeding the
    next run; steps/s by CUDA events, device kernels per step and the
    device's idle share."""
    import torch

    def f(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    params = PM.parcel_params(condensation_growth="Condensation",
                              const_dt=0.1, w=1.0)
    y = PM.ParcelState(S_l=f(1.02), p_air=f(8e4), T=f(278.0), q_vap=f(6e-3),
                       q_liq=f(1e-3), q_ice=f(0.0), N_aer=f(1e8),
                       N_liq=f(1e8), N_ice=f(0.0), ln_inpc=f(0.0))

    def run(y, n=PARCEL_STEPS):
        traj = PM.run_parcel(y, 0.0, n * params.const_dt, params)
        return traj, PM.ParcelState(*(v[-1] for v in traj))

    _, y = run(y, 50)                                  # warm-up
    times = []
    for _ in range(2):
        ms, (traj, y) = _event_ms(lambda: run(y))
        _check_parcel("parcel", traj)
        times.append(ms)
    n_prof = 50
    kernels, busy_ms, span_ms = _kernel_stats(lambda: run(y, n_prof))
    ms_step = min(times) / PARCEL_STEPS
    out = {
        "steps": PARCEL_STEPS, "ms_per_run": times,
        "steps_per_s": PARCEL_STEPS / (min(times) * 1e-3),
        "steps_per_s_median": PARCEL_STEPS / (float(np.median(times)) * 1e-3),
        "kernels_per_step": kernels / n_prof,
        "device_busy_ms_per_step": busy_ms / n_prof,
        "idle_share": 1.0 - (busy_ms / n_prof) / ms_step,
        "idle_share_under_profiler": 1.0 - busy_ms / span_ms,
        "final_S_l": float(y.S_l), "final_T": float(y.T)}
    print(f"  parcel (the TPU bench's, float32, {PARCEL_STEPS} steps a run): "
          f"{out['steps_per_s']:.6g} steps/s best of 2 "
          f"(median {out['steps_per_s_median']:.6g}; ms per run {times}), "
          f"{out['kernels_per_step']:.4g} device kernels per step, busy "
          f"{out['device_busy_ms_per_step'] * 1e3:.4g} us per step, idle "
          f"share {out['idle_share']:.4f} ({out['idle_share_under_profiler']:.4f}"
          f" under the profiler)")
    return out


def _same_member(tag, whole, one, member):
    """Member ``member`` of an ensemble trajectory against its single run
    (over the single run's steps), bit for bit."""
    import torch

    n = one.T.shape[0]
    diff = [name for name, a, b in zip(whole._fields, whole, one)
            if not torch.equal(a[:n, member:member + 1], b)]
    if diff:
        raise AssertionError(f"{tag}: member {member} differs from its "
                             f"single run in {diff}")


def _ensemble_report(tag, n_steps, ms, member_steps, extra=""):
    rate = n_steps / (ms * 1e-3)
    print(f"  {tag}: {ENSEMBLE} members x {n_steps} steps in {ms:.6g} ms: "
          f"{rate:.6g} steps/s, {rate * ENSEMBLE:.6g} member-steps/s; member "
          f"0 bit-identical to its single run (N = 1) over {member_steps} "
          f"steps{extra}")
    return {"members": ENSEMBLE, "steps": n_steps, "ms": ms,
            "steps_per_s": rate, "member_steps_per_s": rate * ENSEMBLE,
            "member0_bit_identical_steps": member_steps}


def _liquid_ensemble(device, PM, TDI, tps):
    """The emulator's dataset parcel (models/emulator.py:284-346): AeroAct
    and condensation on Sulfate, per-member r_nuc, sigma_g, N_aer_act,
    kappa, w, T0 and p0 drawn from seed 0 over its ranges, just-saturated
    initial conditions, t_end 20 s at dt 0.2 s."""
    import dataclasses

    import torch

    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Sulfate

    rng = np.random.default_rng(0)
    n = ENSEMBLE
    r_dry = 10 ** rng.uniform(-8.2, -6.8, (n, 2))
    stdev = rng.uniform(1.4, 2.4, (n, 2))
    N_m = 10 ** rng.uniform(6.5, 9.0, (n, 2))
    kappa = rng.uniform(0.1, 1.2, (n, 2))
    w = 10 ** rng.uniform(-1.0, 0.7, n)
    T0 = rng.uniform(270.0, 300.0, n)
    p0 = rng.uniform(7e4, 1.02e5, n)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    member = dict(r_nuc=f32(r_dry[:, 0]), aero_sigma_g=f32(stdev[:, 0]),
                  N_aer_act=f32(N_m.sum(axis=1)), w=f32(w),
                  kappa=f32(kappa[:, 0]))
    T, p = f32(T0), f32(p0)
    z = torch.zeros_like(T)
    rho = TDI.air_density(tps, T, p, z, z, z)
    q_vap = TDI.p2q(tps, T, rho,
                    TDI.saturation_vapor_pressure_over_liquid(tps, T))
    S0 = float(np.float32(1.0) + np.float32(1e-4))
    ic = PM.ParcelState(S_l=torch.full_like(T, S0), p_air=p, T=T,
                        q_vap=q_vap, q_liq=z, q_ice=z,
                        N_aer=member["N_aer_act"], N_liq=z, N_ice=z,
                        ln_inpc=z)
    base = PM.parcel_params(aerosol_act="AeroAct",
                            condensation_growth="Condensation",
                            aerosol=Sulfate(), aero_sigma_g=2.0,
                            const_dt=0.2)

    def params(sl):
        m = {k: v[sl] for k, v in member.items()}
        kap = m.pop("kappa")
        return dataclasses.replace(base, **m, aerosol=dataclasses.replace(
            base.aerosol, kappa=kap))

    t_end = 20.0
    PM.run_parcel(ic, 0.0, t_end, params(slice(None)))      # warm-up
    ms, traj = _event_ms(lambda: PM.run_parcel(ic, 0.0, t_end,
                                               params(slice(None))))
    _check_parcel("liquid ensemble", traj)
    one = PM.run_parcel(PM.ParcelState(*(v[0:1].clone() for v in ic)), 0.0,
                        t_end, params(slice(0, 1)))
    _same_member("liquid ensemble", traj, one, 0)
    s_max = traj.S_l.max(dim=0).values - 1
    n_steps = traj.S_l.shape[0] - 1
    out = _ensemble_report(
        "liquid ensemble (emulator dataset)", n_steps, ms, n_steps,
        f"; S_max - 1 median {float(s_max.median()):.4g}, range "
        f"{float(s_max.min()):.4g}..{float(s_max.max()):.4g}")
    out["S_max_minus_1_median"] = float(s_max.median())
    return out


def _ice_ensemble(device, PM, TDI, tps):
    """Tully et al. 2023 cirrus, period 1 (examples/parcel_tully_2023.py):
    MohlerAF deposition on desert dust with deposition growth, dt 0.1 s;
    member 0 at the published w = 3.5e-2 m/s, the others at a seeded
    log-uniform w in [1e-2, 1] m/s; the first TULLY_STEPS steps."""
    import dataclasses

    import torch

    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import (
        DesertDust,
    )

    N_aer, p0, T0, qv0 = 2000e3, 20000.0, 230.0, 3.3e-4
    # the example's parcel_ic, in float64 on the host
    R_a = tps.R_d * (1 - qv0) + tps.R_v * qv0
    e_sl = float(TDI.saturation_vapor_pressure_over_liquid(
        tps, torch.tensor(T0, dtype=torch.float64)))
    S0 = qv0 * p0 * tps.R_v / R_a / e_sl
    values = dict(S_l=S0, p_air=p0, T=T0, q_vap=qv0, q_liq=0.0, q_ice=0.0,
                  N_aer=N_aer, N_liq=0.0, N_ice=0.0, ln_inpc=0.0)
    ic = PM.ParcelState(**{k: torch.full((ENSEMBLE,), v, dtype=torch.float32,
                                         device=device)
                           for k, v in values.items()})
    rng = np.random.default_rng(0)
    w = np.concatenate([[3.5e-2], 10 ** rng.uniform(-2.0, 0.0, ENSEMBLE - 1)])
    w = torch.as_tensor(w.astype(np.float32), device=device)
    base = PM.parcel_params(aerosol=DesertDust(), deposition="MohlerAF",
                            deposition_growth="Deposition",
                            liq_size_distribution="Monodisperse",
                            r_nuc=0.5e-4 * 1e-6, const_dt=0.1)
    t_end = TULLY_STEPS * base.const_dt
    ms, traj = _event_ms(lambda: PM.run_parcel(
        ic, 0.0, t_end, dataclasses.replace(base, w=w)))
    _check_parcel("ice ensemble", traj)
    one = PM.run_parcel(PM.ParcelState(*(v[0:1].clone() for v in ic)), 0.0,
                        t_end, dataclasses.replace(base, w=w[0:1]))
    _same_member("ice ensemble", traj, one, 0)
    # the comparison covers MohlerAF nucleation and deposition growth only
    # if member 0 nucleates within the window
    with_ice = torch.nonzero(one.N_ice[:, 0] > 0)
    if with_ice.numel() == 0:
        raise AssertionError("ice ensemble: member 0 nucleates no ice in "
                             f"its {TULLY_STEPS} steps")
    first_ice = int(with_ice[0, 0])
    nucleated = int((traj.N_ice[-1] > 0).sum())
    out = _ensemble_report(
        f"ice ensemble (Tully 2023 period 1, first {TULLY_STEPS} steps)",
        TULLY_STEPS, ms, TULLY_STEPS,
        f"; {nucleated} members with ice at the end, member 0 N_ice "
        f"{float(traj.N_ice[-1, 0]):.4g} /m^3, positive from step "
        f"{first_ice}")
    out["members_with_ice"] = nucleated
    out["member0_first_ice_step"] = first_ice
    return out


def _box_and_sandbox(device, BOX, SB, tps):
    """examples/box_alpert_knopf_2016.py's box (1000 droplets, dt 10 s, 331
    steps), deterministic and stochastic with a seeded generator, and the
    P3 sandbox on tests/test_calibration.py's state; float32 against
    float64 on the card."""
    import torch

    from cloudmicrophysics_tpu_torch.parameters import parameters_p3
    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Illite

    A_aero, sigma_g, N0 = 1e-5 * 1e-4, 10.0, 1000
    T0, cooling, t_end, dt = 256.0, 0.5 / 60, 3310.0, 10.0
    Aj = np.sort(np.random.default_rng(42).lognormal(
        np.log(A_aero), np.log(sigma_g), N0))[::-1].copy()
    N_l, r_l = 500e3, 1e-6
    q_l = N_l * 4 / 3 * np.pi * r_l**3 * 1000.0 / 1.2
    det, sto, sand, ms = {}, {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        def f(v):
            return torch.full((), v, dtype=dtype, device=device)

        ms[dtype], traj = _event_ms(lambda: BOX.run_box(
            BOX.BoxState(f(T0), f(N0 * A_aero), f(float(N0)), f(0.0)), 0.0,
            t_end, tps, Illite(), cooling, A_aero, dt))
        det[dtype] = (traj.N_ice / N0).double()
        _, n_ice = _event_ms(lambda: BOX.run_box_stochastic(
            T0, torch.as_tensor(Aj, dtype=dtype, device=device), 0.0, t_end,
            tps, Illite(), cooling, dt,
            torch.Generator(device=device).manual_seed(7))[2])
        sto[dtype] = n_ice.double() / N0
        sand[dtype] = SB.run_p3_sandbox(
            SB.P3SandboxState(f(100e6), f(1e-3), f(1e-4), f(1e-4 / 200)),
            0.0, 2.0, 1.0, parameters_p3(), tps, Illite(), T=f(251.0),
            p_air=f(800e2), q_vap=f(8.1e-4), q_liq=f(q_l), N_liq=f(N_l),
            r_liq=f(r_l))
    for tag, frac in (("deterministic", det), ("stochastic", sto)):
        for dtype, x in frac.items():
            if not bool(x.isfinite().all()) or bool((x < 0).any()) or bool(
                    (x > 1 + 1e-6).any()):
                raise AssertionError(f"box {tag} {dtype}: frozen fraction "
                                     f"outside [0, 1] or not finite")
    f32, f64 = torch.float32, torch.float64
    d_det = float((det[f32] - det[f64]).abs().max())
    d_sto = abs(float(sto[f32].mean()) - float(sto[f64].mean()))
    (t32, th32), (t64, th64) = sand[f32], sand[f64]
    if any(v.dtype != f32 for v in (*t32, *th32)):
        raise AssertionError("P3 sandbox: a float32 run left float32")
    d_sand = max(float(((a.double() - b).abs() / b.abs()).max())
                 for a, b in zip((t32.N_ice, *th32), (t64.N_ice, *th64)))
    print(f"  box, deterministic: frozen fraction {float(det[f64][-1]):.6g} "
          f"at the end; float32 {ms[f32] / 331 * 1e3:.4g} us/step; float32 "
          f"against float64 max |diff| {d_det:.3e} (tolerance {TOL_BOX})")
    print(f"  box, stochastic: frozen fraction {float(sto[f64][-1]):.6g} at "
          f"the end; mean over the steps float32 {float(sto[f32].mean()):.6g}"
          f", float64 {float(sto[f64].mean()):.6g} (tolerance "
          f"{TOL_BOX_STOCH})")
    print(f"  P3 sandbox: N_ice {float(t64.N_ice[-1]):.9g}, thresholds "
          f"{[float(v) for v in th64]}; float32 against float64 max rel "
          f"{d_sand:.3e} (tolerance {TOL_SANDBOX})")
    if d_det > TOL_BOX or d_sto > TOL_BOX_STOCH or d_sand > TOL_SANDBOX:
        raise AssertionError(f"box/sandbox float32 against float64: "
                             f"{d_det}, {d_sto}, {d_sand}")
    return {"box_frozen_fraction_end": float(det[f64][-1]),
            "box_us_per_step_f32": ms[f32] / 331 * 1e3,
            "box_f32_vs_f64": d_det,
            "box_stochastic_frozen_fraction_end": float(sto[f64][-1]),
            "box_stochastic_mean_diff": d_sto, "sandbox_f32_vs_f64": d_sand}


def _pointwise(device, tps):
    """The point-wise processes at full width, float32 against float64 on
    the card, with times by CUDA events and each float64 call's peak device
    memory."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
        p3_bench_state,
    )
    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA
    from cloudmicrophysics_tpu_torch.ops import common as CO
    from cloudmicrophysics_tpu_torch.ops import diagnostics as CMD
    from cloudmicrophysics_tpu_torch.ops import ice_nucleation as CMI
    from cloudmicrophysics_tpu_torch.ops import p3_processes as P3P
    from cloudmicrophysics_tpu_torch.ops import thermo as TDI
    from cloudmicrophysics_tpu_torch.parameters import (
        AirProperties,
        microphysics_1m_params,
        microphysics_2m_params,
    )
    from cloudmicrophysics_tpu_torch.parameters import aerosol as PA
    from cloudmicrophysics_tpu_torch.parameters import aerosol_species as SP

    results = {}

    def run(name, fn, args, compare, tol, n_cells):
        """float32 time and result, float64 result and peak memory, and the
        float32 error by ``compare`` against ``tol``."""
        ms = min(_time_ms(lambda: fn(*args), reps=3))
        r32 = fn(*args)
        args64 = tuple(a.double() for a in args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r64 = fn(*args64)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        err, compared = compare(r32, r64, args64)
        del args64, r64
        gbs = sum(a.numel() * 4 for a in args) / (ms * 1e-3) / 1e9
        print(f"  {name} over {n_cells} cells: float32 {ms:.6g} ms "
              f"({gbs:.4g} GB/s of inputs), float32 against float64 "
              f"{err:.3e} over {compared} cells (tolerance {tol}); the "
              f"float64 call's peak {peak:.3g} GiB beyond its inputs")
        if not (err <= tol) or not bool(torch.isfinite(r32).all()):
            raise AssertionError(f"{name}: float32 against float64 {err} > "
                                 f"{tol}, or not finite")
        results[name] = {"ms": ms, "err": err, "tol": tol,
                         "f64_peak_gib": peak}

    def dbz_where(mask_fn):
        def cmp(r32, r64, args64):
            m = mask_fn(args64, r64)
            return float((r32.double() - r64).abs()[m].max()), int(m.sum())
        return cmp

    def rel_where(mask_fn):
        def cmp(r32, r64, args64):
            m = mask_fn(args64, r64)
            d = (r32.double() - r64).abs() / r64.abs()
            return float(d[m].max()), int(m.sum())
        return cmp

    eps32 = torch.finfo(torch.float32).eps
    st2 = device_state_2m(NCOL, NLEV, device)
    sb = microphysics_2m_params().warm_rain.seifert_beheng
    args = (st2.q_lcl, st2.q_rai, st2.n_lcl, st2.n_rai, st2.rho)
    del st2
    n2 = NCOL * NLEV
    # below the float32 presence thresholds of the 2M scheme (machine eps)
    # the float32 call treats a species as absent, by design
    def present(a, r):
        return ((a[0] >= eps32) & (a[1] >= eps32) & (a[2] >= eps32)
                & (a[3] >= eps32))

    run("radar_reflectivity_2m",
        lambda *a: CMD.radar_reflectivity_2m(sb, *a), args,
        dbz_where(present), TOL_DBZ, n2)
    run("effective_radius_2m", lambda *a: CMD.effective_radius_2m(sb, *a),
        args, rel_where(lambda a, r: present(a, r) & (r > 0)), TOL_REFF, n2)
    del args
    st1 = device_state(NCOL, NLEV, device)
    rain = microphysics_1m_params().precip.rain
    run("radar_reflectivity_1m",
        lambda q, rho: CMD.radar_reflectivity_1m(rain, q, rho),
        (st1.q_rai, st1.rho), dbz_where(lambda a, r: r == r), TOL_DBZ, n2)
    # two modes (tests/test_aerosol_activation.py): kappa sulfate
    # accumulation, B sea-salt coarse; the 1M state's T, its dry-air
    # pressure, saturated vapour (the ARG assumption) and a seeded w
    su, ss = SP.Sulfate(), SP.Seasalt()
    ad = PA.AerosolDistribution(modes=(
        PA.ModeKappa(r_dry=0.05e-6, stdev=2.0, N=100e6, vol_mix_ratio=(1.0,),
                     mass_mix_ratio=(1.0,), molar_mass=(su.M,),
                     kappa=(su.kappa,)),
        PA.ModeB(r_dry=1.5e-6, stdev=2.1, N=1e6, mass_mix_ratio=(1.0,),
                 soluble_mass_frac=(ss.epsilon,), osmotic_coeff=(ss.phi,),
                 molar_mass=(ss.M,), dissoc=(ss.nu,),
                 aerosol_density=(ss.rho,))))
    ap, aip = PA.AerosolActivationParameters(), AirProperties()
    w = 10 ** (2 * torch.rand(st1.T.shape, device=device,
                              generator=torch.Generator(
                                  device=device).manual_seed(0)) - 1)

    def activated(rho, T, w):
        p = rho * tps.R_d * T
        p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T)
        q_tot = 1 / (1 - tps.Rv_over_Rd * (p_vs - p) / p_vs)
        z = torch.zeros_like(T)
        return AA.total_N_activated(ap, ad, aip, tps, T, p, w, q_tot, z, z)

    run("total_N_activated", activated, (st1.rho, st1.T, w),
        rel_where(lambda a, r: r > 0), TOL_ACT, n2)
    del st1, w
    st3 = p3_bench_state(P3_NCOL, P3_NLEV, device)
    illite = SP.Illite()

    def rh(q_tot, q_lcl, q_rai, q_ice, T, rho):
        q_vap = q_tot - q_lcl - q_rai - q_ice
        return q_vap / TDI.saturation_vapor_specific_content_over_liquid(
            tps, T, rho)

    def het(q_tot, q_lcl, q_rai, q_ice, n_lcl, T, rho):
        RH = rh(q_tot, q_lcl, q_rai, q_ice, T, rho)
        return P3P.het_ice_nucleation(illite, tps, q_lcl, n_lcl, RH, T,
                                      rho)[0]

    def het_mask(a, r):
        # where float32 holds J normal and finite (its rate overflows to
        # inf, and is zeroed, by design)
        J = CMI.ABIFM_J(illite, rh(*a[:4], a[5], a[6])
                        - CO.a_w_ice(tps, a[5]))
        return (J > 1e-20) & (J < 1e37)

    run("het_ice_nucleation", het,
        (st3.q_tot, st3.q_lcl, st3.q_rai, st3.q_ice, st3.n_lcl, st3.T,
         st3.rho), rel_where(het_mask), TOL_HET, P3_NCOL * P3_NLEV)
    return results


def _run_0d(device, gpu_line):
    """Phase 15: the parcel, box and P3-sandbox drivers and the point-wise
    processes under them on the card. Returns the phase's JSON object."""
    import torch

    from cloudmicrophysics_tpu_torch.models import box as BOX
    from cloudmicrophysics_tpu_torch.models import p3_sandbox as SB
    from cloudmicrophysics_tpu_torch.models import parcel as PM
    from cloudmicrophysics_tpu_torch.ops import thermo as TDI
    from cloudmicrophysics_tpu_torch.parameters import ThermodynamicsParameters

    tps = ThermodynamicsParameters()
    torch.cuda.empty_cache()
    print("== 0-D drivers and point-wise processes on the card")
    parts = {"parcel": lambda: _parcel_bench(device, PM),
             "liquid_ensemble": lambda: _liquid_ensemble(device, PM, TDI,
                                                         tps),
             "ice_ensemble": lambda: _ice_ensemble(device, PM, TDI, tps),
             "box_and_sandbox": lambda: _box_and_sandbox(device, BOX, SB,
                                                         tps),
             "pointwise": lambda: _pointwise(device, tps)}
    out, wall = {"gpu": gpu_line}, {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()
        wall[name] = time.perf_counter() - t0
    out["wall_s"] = wall
    print(f"  phase 15 wall seconds by part: "
          f"{ {k: round(v, 2) for k, v in wall.items()} }")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Calibration, emulators and calibrated parameter sets (phase 16)
# ---------------------------------------------------------------------------

# tests/test_calibration.py's chamber: its state and its parcel's options
CHAMBER = dict(T0=251.0, p0=80000.0, N_liq=1e8, r_liq=1e-6)
CHAMBER_KWARGS = dict(heterogeneous="ABIFM",
                      condensation_growth="Condensation", const_dt=1.0,
                      w=0.5)
CHAMBER_WINDOW = 120.0          # s, the AIDA test's window (EKI, AIDA)
UKI_WINDOW = 60.0               # s, the UKI test's window
ABIFM_TRUE = (54.48, -10.67)    # Illite's (m, c)
ABIFM_PRIOR = dict(noise_std=0.02, prior_mean=(50.0, -9.0),
                   prior_std=(8.0, 2.0))
N_TRAIN, N_VAL, N_GP = 16384, 4096, 4096
MLP_STEPS = 2000
TREES = dict(n_trees=300, depth=5, learning_rate=0.12)
TREES_CPU = 20                  # the CPU fit's trees: the card fit's first 20
TREES_GATE_SAMPLES = 2048       # the trees' train-RMSE gate's dataset size
RTOL_UKI = 1e-6                 # UKI on the card against the CPU, theta
CONFIG_SETS = ("CliMA_1M", "SB2006_limiters")


def _calibrated_params(tps):
    """The shipped CliMA_1M and SB2006_limiters sets through the override
    pipeline: a 1M and a 2M parameter block, each one more build."""
    from cloudmicrophysics_tpu_torch.parameters import (
        calibrated_overrides,
        microphysics_1m_params_from_overrides,
        microphysics_2m_params_from_overrides,
    )

    return (microphysics_1m_params_from_overrides(
                calibrated_overrides(CONFIG_SETS[0])),
            microphysics_2m_params_from_overrides(
                calibrated_overrides(CONFIG_SETS[1])))


def _chamber_ic(device, tps):
    """tests/test_calibration.py's chamber state, float64 on ``device``."""
    import torch

    from cloudmicrophysics_tpu_torch.models import parcel as PM
    from cloudmicrophysics_tpu_torch.ops import thermo as TDI

    T0, p0, Nl, r0 = (CHAMBER[k] for k in ("T0", "p0", "N_liq", "r_liq"))
    e = float(TDI.saturation_vapor_pressure_over_liquid(
        tps, torch.tensor(T0, dtype=torch.float64, device=device)))
    md, mv = (p0 - e) / tps.R_d / T0, e / tps.R_v / T0
    ml = Nl * 4 / 3 * np.pi * 1000 * r0**3
    values = dict(S_l=1.0, p_air=p0, T=T0, q_vap=mv / (md + mv + ml),
                  q_liq=ml / (md + mv + ml), q_ice=0.0, N_aer=0.0, N_liq=Nl,
                  N_ice=0.0, ln_inpc=0.0)
    return PM.ParcelState(**{k: torch.tensor(v, dtype=torch.float64,
                                             device=device)
                             for k, v in values.items()}), e


def _chamber_run(ic, m, c, t_end=CHAMBER_WINDOW):
    """The chamber parcel with Illite's ABIFM (m, c): its trajectory and
    its frozen fractions at the 5 observation times (numpy)."""
    import dataclasses

    import torch

    from cloudmicrophysics_tpu_torch.models import parcel as PM
    from cloudmicrophysics_tpu_torch.parameters.aerosol_species import Illite

    aerosol = dataclasses.replace(Illite(), ABIFM_m=m, ABIFM_c=c)
    traj = PM.run_parcel(ic, 0.0, t_end,
                         PM.parcel_params(aerosol=aerosol, **CHAMBER_KWARGS))
    frozen = (traj.N_ice / torch.clamp(traj.N_liq + traj.N_ice, min=1.0)
              ).cpu().numpy()
    return traj, frozen[np.linspace(0, len(frozen) - 1, 5).astype(int)]


def _linear_map(seed, device):
    import torch

    A = torch.as_tensor(np.random.default_rng(seed).normal(size=(6, 2)),
                        device=device)
    return (lambda t: t @ A.T), (A @ torch.tensor(
        [2.0, -1.5], dtype=torch.float64, device=device)).cpu().numpy()


def _cal_eki(device, tps):
    """EKI on tests/test_calibration.py's linear map, then the ABIFM
    perfect model with calibrate_abifm's defaults (25 members, 8
    iterations) over the chamber's 120 s."""
    import torch

    from cloudmicrophysics_tpu_torch.models import calibration as CAL

    forward, y = _linear_map(0, device)
    lin = CAL.eki_calibrate(forward, [0.0, 0.0], [2.0, 2.0], y,
                            np.eye(6) * 1e-6, n_ensemble=30, n_iterations=10,
                            device=device)
    theta = lin.theta.cpu().numpy()
    if not np.allclose(theta, [2.0, -1.5], atol=0.05) or not (
            float(lin.errors[-1]) < float(lin.errors[0])):
        raise AssertionError(f"EKI linear map: theta {theta}, misfits "
                             f"{lin.errors.tolist()}")
    ic, _ = _chamber_ic(device, tps)
    _, y_obs = _chamber_run(ic, *ABIFM_TRUE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = CAL.calibrate_abifm(ic, CHAMBER_WINDOW, CHAMBER_KWARGS, y_obs,
                              device=device, **ABIFM_PRIOR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m, c = (float(v) for v in res.theta)
    _, fit = _chamber_run(ic, m, c)
    errors = res.errors.tolist()
    if not (np.allclose(fit, y_obs, atol=0.05) and errors[-1] <= errors[0]):
        raise AssertionError(f"EKI ABIFM: fit {fit} against {y_obs}, "
                             f"misfits {errors}")
    # an iteration is one forward map (the 25-member parcel over the
    # window) and one Kalman update of a few small products
    n_steps = int(CHAMBER_WINDOW / CHAMBER_KWARGS["const_dt"])
    out = {"linear_theta": theta.tolist(), "theta": [m, c],
           "y_obs": y_obs.tolist(), "y_fit": fit.tolist(), "misfits": errors,
           "s_per_iteration": seconds / res.iterations,
           "ms_per_parcel_step_25_members":
               seconds / res.iterations / n_steps * 1e3}
    print(f"  EKI linear map: theta {theta}; ABIFM (25 members, 8 "
          f"iterations, {CHAMBER_WINDOW:g} s): (m, c) = ({m:.6g}, {c:.6g}) "
          f"(true {ABIFM_TRUE}), frozen fractions {fit} against {y_obs}, "
          f"misfit {errors[0]:.4g} -> {errors[-1]:.4g}; "
          f"{out['s_per_iteration']:.4g} s per iteration, "
          f"{out['ms_per_parcel_step_25_members']:.4g} ms per forward-map "
          f"parcel step (with the update)")
    return out


def _cal_uki(device, tps):
    """UKI on tests/test_calibration.py's linear map, and calibrate_abifm's
    UKI route (5 sigma points, 8 iterations, the test's 60 s) on the card
    and on the CPU."""
    from cloudmicrophysics_tpu_torch.models import calibration as CAL

    forward, y = _linear_map(3, device)
    lin = CAL.uki_calibrate(forward, [0.0, 0.0], [2.0, 2.0], y,
                            np.eye(6) * 1e-6, n_iterations=15, device=device)
    theta = lin.theta.cpu().numpy()
    if not np.allclose(theta, [2.0, -1.5], atol=0.02):
        raise AssertionError(f"UKI linear map: theta {theta}")
    runs = {}
    for where in (device, "cpu"):
        ic, _ = _chamber_ic(where, tps)
        _, y_obs = _chamber_run(ic, *ABIFM_TRUE, t_end=UKI_WINDOW)
        t0 = time.perf_counter()
        runs[str(where)] = CAL.calibrate_abifm(
            ic, UKI_WINDOW, CHAMBER_KWARGS, y_obs, n_iterations=8,
            method="UKI", device=where, **ABIFM_PRIOR), \
            time.perf_counter() - t0
    (card, s_card), (host, s_host) = runs[str(device)], runs["cpu"]
    if card.ensemble.shape != (2, 5):
        raise AssertionError(f"UKI: {card.ensemble.shape[1]} sigma points")
    gap = float(((card.theta.cpu() - host.theta).abs()
                 / host.theta.abs()).max())
    errors = card.errors.tolist()
    if gap > RTOL_UKI or not errors[-1] <= errors[0]:
        raise AssertionError(f"UKI ABIFM: card {card.theta.tolist()} against "
                             f"CPU {host.theta.tolist()} (gap {gap:.3g}), "
                             f"misfits {errors}")
    print(f"  UKI linear map: theta {theta}; ABIFM (5 sigma points, 8 "
          f"iterations, {UKI_WINDOW:g} s): card {card.theta.tolist()} in {s_card:.4g} s, CPU "
          f"float64 {host.theta.tolist()} in {s_host:.4g} s, largest "
          f"relative gap {gap:.3g} (tolerance {RTOL_UKI:g})")
    return {"linear_theta": theta.tolist(), "theta": card.theta.tolist(),
            "theta_cpu": host.theta.tolist(), "gap": gap, "misfits": errors,
            "s_card": s_card, "s_cpu": s_host}


def _cal_aida(device, tps):
    """tests/test_calibration.py's synthetic-.edf chamber workflow: a
    120 s chamber parcel written as an AIDA file (into the ignored build
    directory), unpacked, and calibrated by EKI."""
    from cloudmicrophysics_tpu_torch.kernels import _build
    from cloudmicrophysics_tpu_torch.models import aida as AIDA

    ic, e0 = _chamber_ic(device, tps)
    traj, _ = _chamber_run(ic, *ABIFM_TRUE)
    p, T, N_ice = (v.cpu().numpy() for v in (traj.p_air, traj.T,
                                             traj.N_ice))
    lines = ["# header"] * 225 + [
        f"{float(i):.1f} {p[i] / 100:.3f} {T[i]:.3f} {e0:.3f} 0 "
        f"{N_ice[i] / 1e6:.6e}" for i in range(len(p))]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    edf = _build.BUILD_DIR / "synthetic_aida.edf"
    edf.write_text("\n".join(lines) + "\n")
    prof = AIDA.unpack_aida_edf(edf)
    t0 = time.perf_counter()
    res = AIDA.calibrate_abifm_aida(
        prof, 0.0, CHAMBER_WINDOW, CHAMBER["N_liq"], CHAMBER["N_liq"],
        CHAMBER["r_liq"], n_ensemble=20, n_iterations=6, device=device,
        **ABIFM_PRIOR)
    seconds = time.perf_counter() - t0
    errors = res.errors.tolist()
    ratio = errors[-1] / errors[0]
    if not ratio < 1e-3:
        raise AssertionError(f"AIDA: misfit ratio {ratio:.3g}, {errors}")
    print(f"  AIDA synthetic chamber: (m, c) = {res.theta.tolist()}, misfit "
          f"ratio {ratio:.3g} (gate 1e-3), {seconds:.4g} s")
    return {"theta": res.theta.tolist(), "misfit_ratio": ratio,
            "s": seconds}


def _activation_gate(EM, model, params, ap, aip, tps, device):
    """The largest |emulated - exact ARG| / N over tests/test_calibration.py's
    three two-mode states."""
    import torch

    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
        ModeKappa,
    )

    worst = 0.0
    for N1, N2, r, w, T, p in ((1e8, 5e8, 5e-8, 1.0, 290.0, 9e4),
                               (5e7, 2e8, 8e-8, 0.5, 283.0, 8.5e4),
                               (3e8, 1e8, 4e-8, 2.0, 295.0, 9.5e4)):
        ad = AerosolDistribution(modes=tuple(
            ModeKappa(r_dry=r, stdev=2.0, N=N, vol_mix_ratio=(1.0,),
                      mass_mix_ratio=(1.0,), molar_mass=(0.13214,),
                      kappa=(0.53,)) for N in (N1, N2)))
        em = EM.N_activated_per_mode_emulated(model, params, ap, ad, aip, tps,
                                              T, p, w, 0.01, 0.0, 0.0)
        ex = AA.N_activated_per_mode(
            ap, ad, aip, tps, *(torch.tensor(v, dtype=torch.float64,
                                             device=device)
                                for v in (T, p, w, 0.01)), 0.0, 0.0)
        worst = max(worst, *(abs(float(e) - float(x)) / N
                             for e, x, N in zip(em, ex, (N1, N2))))
    return worst


def _cal_emulators(device, tps, n_train=N_TRAIN, n_val=N_VAL, n_gp=N_GP,
                   mlp_steps=MLP_STEPS, trees=TREES, trees_cpu=TREES_CPU):
    """The ARG datasets on the card and the three families fitted to them,
    each held to tests/test_calibration.py's gates."""
    import torch

    from cloudmicrophysics_tpu_torch.models import emulator as EM
    from cloudmicrophysics_tpu_torch.parameters import AirProperties
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolActivationParameters,
    )

    ap, aip = AerosolActivationParameters(), AirProperties()
    t0 = time.perf_counter()
    X, y = EM.generate_training_data(ap, aip, tps, n_samples=n_train, seed=1,
                                     device=device)
    X2, y2 = EM.generate_training_data(ap, aip, tps, n_samples=n_val, seed=2,
                                       device=device)
    out = {"datasets_s": time.perf_counter() - t0}

    def timed(fit):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fit()
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    def val_rmse(model, params):
        pred = EM._predict(model, params, X2).detach().cpu().numpy()
        return float(np.sqrt(np.mean((pred - y2) ** 2)))

    # the process's first training step costs seconds (the libraries'
    # first use), timed apart from the fit
    _, warm = timed(lambda: EM.train_emulator(X[:64], y[:64], n_steps=2,
                                              device=device))
    (mlp, mlp_p, loss), s = timed(lambda: EM.train_emulator(
        X, y, hidden=(64, 64), n_steps=mlp_steps, device=device))
    # device kernels and busy time per Adam step: 30 steps less 10
    stats = [_kernel_stats(lambda n=n: EM.train_emulator(
        X, y, n_steps=n, device=device)) for n in (10, 30)]
    kernels, busy = ((None, None) if None in stats else
                     ((b - a) / 20 for a, b in zip(stats[0][:2],
                                                   stats[1][:2])))
    out["mlp"] = {"loss": loss, "val_rmse": val_rmse(mlp, mlp_p),
                  "activation_err": _activation_gate(EM, mlp, mlp_p, ap, aip,
                                                     tps, device), "s": s,
                  "ms_per_step": s / mlp_steps * 1e3, "first_call_s": warm,
                  "kernels_per_step": kernels,
                  "device_busy_ms_per_step": busy}
    (gp, gp_p, rmse), s = timed(lambda: EM.train_emulator_gp(
        X[:n_gp], y[:n_gp], device=device))
    out["gp"] = {"train_rmse": rmse, "val_rmse": val_rmse(gp, gp_p),
                 "activation_err": _activation_gate(EM, gp, gp_p, ap, aip,
                                                    tps, device), "s": s}
    (tr, tr_p, rmse), s = timed(lambda: EM.train_emulator_trees(
        X, y, device=device, **trees))
    again, s2 = timed(lambda: EM.train_emulator_trees(
        X, y, device=device, **trees)[1])
    (_, cpu_p, _), s_cpu = timed(lambda: EM.train_emulator_trees(
        X, y, device="cpu", **dict(trees, n_trees=trees_cpu)))
    # the train-RMSE gate is tests/test_calibration.py's, for a forest of
    # its size fitted to its 2048 samples: 300 depth-5 trees fit 16384
    # samples less closely (the JAX fit's algorithm, split for split)
    (_, _, rmse_gate), _ = timed(lambda: EM.train_emulator_trees(
        X[:TREES_GATE_SAMPLES], y[:TREES_GATE_SAMPLES], device=device,
        **trees))
    differ = ((tr_p["features"][:trees_cpu].cpu() != cpu_p["features"])
              | (tr_p["thresholds"][:trees_cpu].cpu()
                 != cpu_p["thresholds"]))
    out["trees"] = {
        "train_rmse": rmse_gate, "train_rmse_all": rmse,
        "val_rmse": val_rmse(tr, tr_p),
        "activation_err": _activation_gate(EM, tr, tr_p, ap, aip, tps,
                                           device),
        "s": s, "s_second_fit": s2,
        "deterministic": all(torch.equal(tr_p[k], again[k]) for k in tr_p),
        "splits_differing_from_cpu": int(differ.sum()),
        "splits_compared": differ.numel(), "s_cpu": s_cpu}
    for fam, gates in (("mlp", dict(loss=0.01, val_rmse=0.1,
                                     activation_err=0.15)),
                       ("gp", dict(train_rmse=0.05, val_rmse=0.1,
                                   activation_err=0.15)),
                       ("trees", dict(train_rmse=0.05, val_rmse=0.1,
                                      activation_err=0.15))):
        r = out[fam]
        print(f"  {fam}: " + ", ".join(
            f"{k} {r[k]:.4g} (gate {g:g})" for k, g in gates.items())
            + f"; fit {r['s']:.4g} s")
        bad = [k for k, g in gates.items() if not r[k] < g]
        if bad:
            raise AssertionError(f"emulator {fam}: {bad} missed its gate")
    print(f"  mlp: {out['mlp']['ms_per_step']:.4g} ms per Adam step, "
          + ("device time not measured (the profiler saw none)"
             if kernels is None else f"{kernels:.4g} device kernels and "
             f"{busy:.4g} ms of device time a step (torch.profiler)")
          + f"; a first 2-step call before the fit {warm:.4g} s")
    t = out["trees"]
    print(f"  trees: second fit {t['s_second_fit']:.4g} s, "
          + ("equal to the first" if t["deterministic"] else "DIFFERS")
          + f"; train RMSE over all {n_train} samples "
          f"{t['train_rmse_all']:.4g} (train_rmse above: the first "
          f"{TREES_GATE_SAMPLES})"
          + f"; {t['splits_differing_from_cpu']} of {t['splits_compared']} "
          f"splits of the first {trees_cpu} trees differ from the CPU fit "
          f"({t['s_cpu']:.4g} s)")
    if not t["deterministic"]:
        raise AssertionError("two tree fits on the card differ")
    return out


def _cal_parcel_dataset(device, tps, n=ENSEMBLE):
    """generate_parcel_training_data at ``n`` members, its defaults (t_end
    20 s, dt 0.2 s), with the ARG labels of the same samples."""
    import torch

    from cloudmicrophysics_tpu_torch.models import emulator as EM
    from cloudmicrophysics_tpu_torch.parameters import AirProperties
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolActivationParameters,
    )

    ap, aip = AerosolActivationParameters(), AirProperties()
    EM.generate_parcel_training_data(ap, aip, tps, n_samples=n, t_end=0.4,
                                     device=device)             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, y, y_arg = EM.generate_parcel_training_data(
        ap, aip, tps, n_samples=n, return_arg_labels=True, device=device)
    seconds = time.perf_counter() - t0
    steps = int(round(20.0 / 0.2))
    corr = float(np.corrcoef(y, y_arg)[0, 1])
    out = {"members": n, "steps": steps, "s": seconds,
           "member_steps_per_s": n * steps / seconds,
           "label_std": float(y.std()), "corr_with_arg": corr}
    print(f"  parcel dataset: {n} members x {steps} steps in {seconds:.4g} s "
          f"({out['member_steps_per_s']:.6g} member-steps/s), labels std "
          f"{y.std():.4g}, correlation with ARG {corr:.4g}")
    if not (np.isfinite(X).all() and np.all((y >= 0) & (y <= 1))
            and y.std() > 0.01 and corr > 0.5):
        raise AssertionError("parcel dataset missed its gates")
    return out


def _cal_config(device, K, K2M, tps, tv):
    """The calibrated 1M and 2M sets through Column1MStep and Column2MStep:
    bit for bit against the plain step at (4096, 128) and at full size,
    and the full-size ms/step of each."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
    )
    from cloudmicrophysics_tpu_torch.models.column import (
        Column1MStep,
        Column2MStep,
    )

    mp1, mp2 = _calibrated_params(tps)
    bits, out = [0, 0], {}
    for key, model, state, pack, plain, label in (
            ("K1", Column1MStep(mp1, tps, tv, DT, DZ, device=device),
             device_state, K.pack_state,
             lambda s: K.step_column_1m_packed_plain(s, mp1, tps, tv, DT, DZ),
             CONFIG_SETS[0]),
            ("K3", Column2MStep(mp2, tps, DT, DZ, device=device),
             device_state_2m, K2M.pack_state_2m,
             lambda s: K2M.step_column_2m_packed_plain(s, mp2, tps, DT, DZ),
             CONFIG_SETS[1])):
        for ncol in (4096, NCOL):
            packed = pack(state(ncol, NLEV, device, seed=7))
            _same(f"{key} {label} ({ncol}, {NLEV})", model(packed),
                  plain(packed), bits)
        ms = min(_time_ms(lambda: model(packed), reps=5))
        out[key] = {"set": label, "ms_per_step": ms}
        print(f"  {key} with {label}: {ms:.6g} ms/step at ({NCOL}, {NLEV})")
        del packed
    print(f"  calibrated blocks bit-identical to the plain step in {bits[0]} "
          f"of {bits[1]} comparisons")
    if bits[0] != bits[1]:
        raise AssertionError("a calibrated block's kernel differs from the "
                             "plain step")
    out["bit_identical"] = bits
    return out


def _run_calibration(device, gpu_line, K, K2M):
    """Phase 16: calibration (EKI, UKI, AIDA), the three activation
    emulators and the calibrated parameter sets on the card, with the K1
    and K3 launch counters read just before and again just after.
    Returns the phase's JSON object."""
    import torch

    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        terminal_velocity_params,
    )

    tps, tv = ThermodynamicsParameters(), terminal_velocity_params()
    torch.cuda.empty_cache()
    print("== calibration, emulators and calibrated parameter sets")
    print(f"  float32 matmul precision {torch.get_float32_matmul_precision()}"
          f", TF32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on")
    counters = {"K1": K.step_column_1m_fused_packed,
                "K3": K2M.step_column_2m_fused_packed}
    base = _launch_counts(counters)
    parts = {"eki": lambda: _cal_eki(device, tps),
             "uki": lambda: _cal_uki(device, tps),
             "aida": lambda: _cal_aida(device, tps),
             "emulators": lambda: _cal_emulators(device, tps),
             "parcel_dataset": lambda: _cal_parcel_dataset(device, tps),
             "config": lambda: _cal_config(device, K, K2M, tps, tv)}
    out, wall = {"gpu": gpu_line}, {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()
        wall[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["launches"] = _launch_counts(counters, base)
    out["wall_s"] = wall
    print(f"  launches in this path: {out['launches']}")
    print(f"  phase 16 wall seconds by part: "
          f"{ {k: round(v, 2) for k, v in wall.items()} }, total "
          f"{sum(wall.values()):.4g}")
    if not all(out["launches"].values()):
        raise AssertionError(f"a kernel of phase 16 never launched: "
                             f"{out['launches']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Column sharding over torch.distributed (phase 17)
# ---------------------------------------------------------------------------

SHARD_STEPS = 10        # steps of a timed rollout, queued back to back
SHARD_ORDER = ("unsharded", "sharded", "sharded", "unsharded") * 2
SHARD_IDLE_CALLS = 10   # steps under torch.profiler for the idle share
SHARD_RANKS = 2         # ranks of (b) and (c), sharing card 0 over gloo


def _shard_paths(device):
    """The paths phase 17 shards, at full width: (tag, kernel, step, first
    input, launch counter). A step maps its input to the next one: a
    ``ColumnState`` through ``Column1MStep`` (K2), a ``ColumnState2M``
    through ``step_column_2m(impl="fused")`` (K4 on each rank's shard),
    and a ``(ColumnStateP3, log lambda)`` pair through
    ``ColumnP3Step`` at GL-16 (K5; the first input's guess is None, so the
    first step is cold and the next ones warm-started)."""
    from cloudmicrophysics_tpu_torch.kernels import column1m as K
    from cloudmicrophysics_tpu_torch.kernels import column2m as K2M
    from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
        p3_bench_state,
    )
    from cloudmicrophysics_tpu_torch.models.column import (
        Column1MStep,
        ColumnP3Step,
        step_column_2m,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        microphysics_2m_params,
        terminal_velocity_params,
    )

    tps = ThermodynamicsParameters()
    m1 = Column1MStep(microphysics_1m_params(), tps,
                      terminal_velocity_params(), DT, DZ, device=device)
    mp2 = microphysics_2m_params()
    m3 = ColumnP3Step(microphysics_2m_params(with_ice=True,
                                             quadrature_order=16),
                      tps, DT, DZ, device=device)
    return [
        ("1M", "K2", m1, lambda: device_state(NCOL, NLEV, device),
         K.step_column_1m_fused),
        ("2M", "K4",
         lambda s: step_column_2m(s, mp2, tps, DT, DZ, impl="fused"),
         lambda: device_state_2m(NCOL, NLEV, device),
         K2M.step_column_2m_fused),
        ("P3", "K5", lambda x: m3(*x),
         lambda: (p3_bench_state(P3_NCOL, P3_NLEV, device), None),
         K5.step_column_p3_fused),
    ]


def _rollout(step, x, n):
    for _ in range(n):
        x = step(x)
    return x


def _local(tree, device=None):
    """``tree`` with each DTensor replaced by this rank's shard, moved to
    ``device`` when given."""
    from cloudmicrophysics_tpu_torch.parallel import is_dtensor
    from cloudmicrophysics_tpu_torch.perf import _map

    return _map(lambda t: (t.to_local() if is_dtensor(t) else t).to(
        device or t.device), tree)


def _identical(a, b):
    import torch

    from cloudmicrophysics_tpu_torch.perf import _leaves

    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _host_ms(step, x, calls=SHARD_STEPS):
    """Host milliseconds to enqueue a step (no synchronize between the
    calls), the best of ``calls``."""
    import torch

    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(calls):
        t0 = time.perf_counter()
        step(x)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3


def _shard_rank(out_dir):
    """Phase 17 (b) and (c) on one of two ranks that share card 0 over
    gloo. (b): each path on this rank's half of the columns of (a)'s input
    (``shard_columns`` over the global input, which (a) saved into
    ``out_dir`` and which is read here mapped, so each rank reads the
    pages of its half), two steps (P3: cold, then warm), then a rollout of
    ``SHARD_STEPS`` steps timed for the pair by the host clock between two
    barriers; saves this rank's shard of the two steps' result (its
    tensors, on the CPU), its launch count and the pair's ms/step into
    ``out_dir``. (c): ``dryrun_multichip(2)`` on the same two ranks; rank
    0 saves its row."""
    import torch
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import (
        column_mesh,
        shard_columns,
    )
    from cloudmicrophysics_tpu_torch.parallel.dryrun import (
        check_sharded,
        dryrun_multichip,
    )
    from cloudmicrophysics_tpu_torch.perf import _leaves

    out_dir = Path(out_dir)
    # the card dryrun.spawn set for this rank
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = column_mesh()
    rank = dist.get_rank()
    for tag, _, step, _, counter in _shard_paths(device):
        x = torch.load(out_dir / f"{tag}_input.pt", mmap=True,
                       weights_only=False)   # written by (a) in this run
        xs = shard_columns(x, mesh)
        torch.cuda.synchronize()
        base = _launch_counts({tag: counter})
        out = _rollout(step, xs, 2)
        dist.barrier()
        t0 = time.perf_counter()
        _rollout(step, out, SHARD_STEPS)
        torch.cuda.synchronize()
        dist.barrier()
        pair_s = time.perf_counter() - t0
        launches = _launch_counts({tag: counter}, base)[tag]
        check_sharded(f"{tag} rank {rank}", out)
        torch.save({"out": list(_leaves(_local(out, "cpu"))),
                    "launches": launches,
                    "pair_ms_per_step": pair_s * 1e3 / SHARD_STEPS},
                   out_dir / f"{tag}_{rank}.pt")
        del x, xs, out
        torch.cuda.empty_cache()
    row = dryrun_multichip(SHARD_RANKS)
    if rank == 0:
        (out_dir / "dryrun.json").write_text(json.dumps(row))


def _run_sharded(device, gpu_line):
    """Phase 17: the column steps sharded over ``torch.distributed``.
    (a) one rank, NCCL, world 1, full width: K2, K4 and K5 through the
    sharded entry points, each two steps bit for bit against the unsharded
    module, timed against it by CUDA events (rollouts of ``SHARD_STEPS``
    steps in the order ``SHARD_ORDER``; the best of each), with the host
    time to enqueue a step and the device's idle share over sharded
    steps, and the launch counter of each path read just before each
    sharded run and again just after; (b) two ranks sharing card 0 over
    gloo, each on half the columns of (a)'s inputs, the two steps' shards
    gathered on the CPU bit for bit against (a), and the pair's ms/step;
    (c) ``dryrun_multichip(2)`` on the same two ranks. Returns the phase's
    JSON object."""
    import tempfile

    import torch
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import (
        column_mesh,
        shard_columns,
    )
    from cloudmicrophysics_tpu_torch.parallel.dryrun import spawn
    from cloudmicrophysics_tpu_torch.perf import _cat

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print("== phase 17: column sharding over torch.distributed")
    result, wall = {"gpu": gpu_line, "world1": {}, "two_ranks": {}}, {}
    refs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        mesh = column_mesh()                   # a one-rank NCCL group
        try:
            print(f"  (a) {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}")
            for tag, kernel, step, first, counter in _shard_paths(device):
                t0 = time.perf_counter()
                x = first()
                torch.save(_local(x, "cpu"), tmp / f"{tag}_input.pt")
                wall[f"a {tag} state"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                result["world1"][tag] = _world1_path(
                    tag, kernel, step, x, counter,
                    shard_columns(x, mesh), refs)
                wall[f"a {tag} steps"] = time.perf_counter() - t0
                del x
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        t0 = time.perf_counter()
        spawn(_shard_rank, SHARD_RANKS, "cuda", (str(tmp),))
        wall["b, c ranks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for tag in refs:
            parts = [torch.load(tmp / f"{tag}_{r}.pt")
                     for r in range(SHARD_RANKS)]
            if not _identical(_cat([p["out"] for p in parts]), refs[tag]):
                raise AssertionError(f"{tag}: the two ranks' gathered shards "
                                     f"differ from the one-rank result")
            launches = [p["launches"] for p in parts]
            if launches != [2 + SHARD_STEPS] * SHARD_RANKS:
                raise AssertionError(f"{tag}: launches per rank {launches}, "
                                     f"{2 + SHARD_STEPS} steps driven")
            pair = max(p["pair_ms_per_step"] for p in parts)
            result["two_ranks"][tag] = {
                "bit_identical": True, "launches": launches,
                "pair_ms_per_step": pair,
                "pair_over_one_rank":
                    pair / result["world1"][tag]["ms_per_step"]["sharded"],
                "note": "two ranks time-slice one card: not a scaling "
                        "number"}
            print(f"  (b) {tag}: {SHARD_RANKS} gloo ranks on one card, "
                  f"gathered shards bit-identical to (a); launches per rank "
                  f"{launches}; the pair {pair:.6g} ms/step (host clock "
                  f"between barriers; not a scaling number)")
        result["dryrun"] = json.loads((tmp / "dryrun.json").read_text())
        wall["b gather"] = time.perf_counter() - t0
    print(f"  (c) dryrun_multichip({SHARD_RANKS}) on the card: "
          f"{result['dryrun']}")
    result["wall_s"] = wall
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 wall seconds by part: "
          f"{ {k: round(v, 2) for k, v in wall.items()} }, total "
          f"{result['phase_s']:.4g}")
    return result


def _world1_path(tag, kernel, step, x, counter, xs, refs):
    """Phase 17 (a) for one path: ``step`` on the input ``x`` and on its
    one-rank sharding ``xs``, two steps each, bit for bit; their rollouts
    timed in turns; the host time to enqueue a step; the idle share over
    sharded steps; the sharded launches against the sharded steps driven.
    Keeps the unsharded result on the CPU in ``refs[tag]`` and returns the
    path's JSON row."""
    import torch

    from cloudmicrophysics_tpu_torch.parallel.dryrun import check_sharded

    counts = [0, 0]      # launches in the sharded runs, sharded steps driven

    def counted(fn, steps):
        torch.cuda.synchronize()
        base = _launch_counts({tag: counter})
        value = fn()
        counts[0] += _launch_counts({tag: counter}, base)[tag]
        counts[1] += steps
        return value

    ref = _rollout(step, x, 2)
    out = counted(lambda: _rollout(step, xs, 2), 2)
    check_sharded(f"{tag} world 1", out)
    if not _identical(_local(out), ref):
        raise AssertionError(f"{tag}: the sharded steps differ from the "
                             f"unsharded module's")
    runs = {"unsharded": lambda: _rollout(step, ref, SHARD_STEPS),
            "sharded": lambda: _rollout(step, out, SHARD_STEPS)}
    times = {"unsharded": [], "sharded": []}
    for name in SHARD_ORDER:
        timed = lambda: _time_ms(runs[name], reps=1, warmup=0)
        times[name] += (counted(timed, SHARD_STEPS) if name == "sharded"
                        else timed())
    host = {"unsharded": _host_ms(step, ref),
            "sharded": counted(lambda: _host_ms(step, out), SHARD_STEPS)}
    trace = lambda: _idle_share(lambda: step(out), SHARD_IDLE_CALLS)
    idle = counted(trace, SHARD_IDLE_CALLS)
    if idle is None:    # a trace of this phase has come back without device
        idle = counted(trace, SHARD_IDLE_CALLS)    # time once: trace again
    if counts[0] != counts[1] or not counts[0]:
        raise AssertionError(f"{tag}: {kernel} launched {counts[0]} times in "
                             f"the sharded runs, {counts[1]} steps driven")
    ms = {k: min(v) / SHARD_STEPS for k, v in times.items()}
    row = {"kernel": kernel, "bit_identical": True, "launches": counts[0],
           "ms_per_step": ms,
           "sharded_over_unsharded": ms["sharded"] / ms["unsharded"],
           "samples_ms_per_step": {k: [t / SHARD_STEPS for t in v]
                                   for k, v in times.items()},
           "host_ms_per_step": host, "idle_share_sharded": idle}
    print(f"  (a) {tag} ({kernel}): two steps bit-identical to the "
          f"unsharded module; ms/step unsharded {ms['unsharded']:.6g}, "
          f"sharded {ms['sharded']:.6g} (ratio "
          f"{row['sharded_over_unsharded']:.6g}); host ms to enqueue a step "
          f"{host}; device idle share over {SHARD_IDLE_CALLS} sharded steps "
          + ("not measured, the profiler saw no device time" if idle is None
             else f"{idle:.6g}")
          + f"; {kernel} launches {counts[0]} (= sharded steps driven)")
    refs[tag] = _local(ref, "cpu")
    return row


# ---------------------------------------------------------------------------
# The K1-K4 scope (phase 18)
# ---------------------------------------------------------------------------

SCOPE_SHAPES = ((4096, 64, 256), (512, 37, 64))   # (ncol, nlev, block_cols)
SCOPE_LEVELS = ((256, 512, 32), (256, 333, 16))   # 512, and not a multiple of 32
NSUBS = (1, 2, 4)
DT_LIN = 10.0                   # a host model's step, taken in nsub substeps
LEVELS_NCOL = 131072            # columns of the 512-level cell at full width
SLICE_NCOL = 65536              # the slice checked where the plain step's
#                                 temporaries do not fit at full width
SCOPE_STEPS = 30                # rollout of a timed configuration
# each non-default option, each slot disabled, every slot disabled, a mix
ALTERNATIVES = (("cloud_ice_formation", "TemperatureDependent"),
                ("rain_autoconversion", "PrescribedNd"),
                ("snow_autoconversion", "WithSupersaturation"),
                ("snow_deposition_sublimation", "SublimationOnly"))
MIXED = dict(ALTERNATIVES, cloud_ice_melt=None, rain_snow_accretion=None)
RECORD_RTOL, RECORD_ATOL_REL = 1e-9, 1e-12   # tests/test_torch_column_records.py


def _scope_options(K):
    """Phase 18's 1M option sets: (label, microphysics_1m_params keywords)."""
    cases = [(f"{slot}={opt}", {slot: opt}) for slot, opt in ALTERNATIVES]
    cases += [(f"{slot}=None", {slot: None}) for slot in K.OPTION_CODES]
    cases += [("every slot None", {slot: None for slot in K.OPTION_CODES}),
              ("mixed", MIXED)]
    return cases


def _scope_builds(K, K2M, tps, tv):
    """Phase 18's libraries, built in phase 2's pool: (source, label,
    build): column1m.cu in linearized_average, for each option set and at
    float64 in both modes; column2m.cu at float64 for each 2M variant."""
    import torch

    from cloudmicrophysics_tpu_torch.parameters import (
        microphysics_1m_params,
        microphysics_2m_params,
    )

    mp = microphysics_1m_params()
    out = []
    for mode, dtype in (("linearized_average", torch.float32),
                        ("instantaneous", torch.float64),
                        ("linearized_average", torch.float64)):
        out.append((K.SOURCE, f"{mode}, {dtype}",
                    lambda m=mode, d=dtype: K._library(
                        K.kernel_params(mp, tps, tv, d), "kernel",
                        K.variant(mp, m))))
    for label, opts in _scope_options(K):
        m = microphysics_1m_params(**opts)
        out.append((K.SOURCE, label, lambda m=m: K._library(
            K.kernel_params(m, tps, tv), "kernel", K.variant(m))))
    for tag, opts in BLOCKS_2M:
        m = microphysics_2m_params(**opts)
        out.append((K2M.SOURCE, f"{tag}, torch.float64",
                    lambda m=m: K2M._library(
                        K2M.kernel_params_2m(m, tps, torch.float64),
                        K2M._variant(m))))
    return out


def _max_abs(out, ref):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(out, ref))


def _f64_rounding(device):
    """How PyTorch's CUDA kernels round float64 ``x / c`` and ``c / x`` for
    a Python float c: counts of cells equal to the candidate forms."""
    import torch

    g = torch.Generator(device=device).manual_seed(5)
    x = torch.rand(1 << 20, dtype=torch.float64, device=device,
                   generator=g) * 1e3 + 1e-3
    rows = []
    for c in (3.0, 7.0, 10.0, 461.5, 1004.5, 0.1, 2.26e-5):
        div = x / c
        ieee = x / torch.full_like(x, c)
        recip = x * (1.0 / c)
        rows.append((c, int((div == recip).sum()), int((div == ieee).sum()),
                     int(((c / x) == (torch.reciprocal(x) * c)).sum())))
    print(f"  float64 rounding on the card ({x.numel()} cells each): "
          + "; ".join(f"x / {c:g}: {a} equal x * (1/c), {b} equal IEEE "
                      f"x / c; c / x: {r} equal reciprocal(x) * c"
                      for c, a, b, r in rows))
    return rows


def _state64(recipe, ncol, nlev, device, cls):
    import torch

    return cls(*(torch.from_numpy(a).to(device) for a in recipe(ncol, nlev)))


def _scope_parity(device, K, K2M, tps, tv, bits, errs):
    """Phase 18's parity at small sizes: K1/K2 (packed, unpacked) in
    linearized_average, under each option set and at float64, K3/K4 at
    float64, K1-K4 at 512 and 333 levels, each bit for bit against its
    plain step."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
        state_recipe,
        state_recipe_2m,
    )
    from cloudmicrophysics_tpu_torch.models.column import (
        ColumnState,
        ColumnState2M,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        microphysics_1m_params,
        microphysics_2m_params,
    )

    def one_1m(name, mp, st, bc, dt=DT, **kw):
        params = K.kernel_params(mp, tps, tv, st.rho.dtype)
        ref = K.step_column_1m_plain(st, mp, tps, tv, dt, DZ, **kw)
        out = K.step_column_1m_fused(st, mp, tps, tv, dt, DZ, block_cols=bc,
                                     params=params, **kw)
        pout = K.unpack_state(K.step_column_1m_fused_packed(
            K.pack_state(st), mp, tps, tv, dt, DZ, block_cols=bc,
            params=params, **kw))
        for k, o in (("K2", out), ("K1", pout)):
            err = _max_abs(o, ref)
            errs[(k, name)] = max(errs.get((k, name), 0.0), err)
            if not _same(f"{k} {name} {tuple(st.rho.shape)}, max abs err "
                         f"{err:.3e}", o, ref, bits):
                raise AssertionError(f"{k} {name} differs from its plain step")

    def one_2m(name, mp, st, bc):
        params = K2M.kernel_params_2m(mp, tps, st.rho.dtype)
        ref = K2M.step_column_2m_plain(st, mp, tps, DT, DZ)
        out = K2M.step_column_2m_fused(st, mp, tps, DT, DZ, block_cols=bc,
                                       params=params)
        pout = K2M.unpack_state_2m(K2M.step_column_2m_fused_packed(
            K2M.pack_state_2m(st), mp, tps, DT, DZ, block_cols=bc,
            params=params))
        for k, o in (("K4", out), ("K3", pout)):
            err = _max_abs(o, ref)
            errs[(k, name)] = max(errs.get((k, name), 0.0), err)
            if not _same(f"{k} {name} {tuple(st.rho.shape)}, max abs err "
                         f"{err:.3e}", o, ref, bits):
                raise AssertionError(f"{k} {name} differs from its plain step")

    mp = microphysics_1m_params()
    for ncol, nlev, bc in SCOPE_SHAPES:
        st = device_state(ncol, nlev, device, seed=7)
        for nsub in NSUBS:
            for sed in (True, False):
                one_1m(f"linearized_average nsub={nsub}"
                       + ("" if sed else " sediment_cloud=False"), mp, st, bc,
                       dt=DT_LIN, mode="linearized_average", nsub=nsub,
                       sediment_cloud=sed)
        for label, opts in _scope_options(K):
            one_1m(label, microphysics_1m_params(**opts), st, bc)
        st64 = _state64(state_recipe, ncol, nlev, device, ColumnState)
        one_1m("float64", mp, st64, bc)
        one_1m("float64 linearized_average nsub=4", mp, st64, bc, dt=DT_LIN,
               mode="linearized_average", nsub=4)
        st2 = _state64(state_recipe_2m, ncol, nlev, device, ColumnState2M)
        for tag, opts in BLOCKS_2M:
            one_2m(f"float64 {tag}", microphysics_2m_params(**opts), st2,
                   bc // 16)
    mp2 = microphysics_2m_params()
    for ncol, nlev, bc in SCOPE_LEVELS:
        one_1m(f"{nlev} levels", mp, device_state(ncol, nlev, device, seed=7),
               bc)
        one_1m(f"{nlev} levels linearized_average nsub=2", mp,
               device_state(ncol, nlev, device, seed=7), bc, dt=DT_LIN,
               mode="linearized_average", nsub=2)
        one_2m(f"{nlev} levels", mp2, device_state_2m(ncol, nlev, device,
                                                       seed=7), bc)


def _checked_full(tags, step, plain, state, bits, cls, pack, unpack):
    """One step of a full-width configuration through the packed and the
    field kernel (``tags``: their names), each held bit for bit against
    the plain step: at full width where the plain step's temporaries fit
    on the card, else on the first SLICE_NCOL columns (said so). Returns
    each kernel's max abs error (packed, fields)."""
    import torch

    try:
        ref = plain(state)
        where = "full width"
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        state = cls(*(t[:SLICE_NCOL].contiguous() for t in state))
        ref = plain(state)
        where = (f"the first {SLICE_NCOL} columns (the plain step's "
                 f"temporaries do not fit at full width)")
    errs = []
    for tag, packed in zip(tags, (True, False)):
        out = unpack(step(pack(state))) if packed else step(state)
        err = _max_abs(out, ref)
        if not _same(f"{tag} one step at {where}, max abs err {err:.3e}",
                     out, ref, bits):
            raise AssertionError(f"{tag} differs from its plain step")
        errs.append(err)
        del out
    del ref
    torch.cuda.empty_cache()
    return errs


def _timed(tag, model, x, counter):
    """Best single launch (10, by CUDA events) and a SCOPE_STEPS rollout of
    ``model`` on ``x`` (a packed state or a field state), with ``counter``
    (the wrapper it launches) read just before and again just after;
    fails unless every call launched it and the rollout ends finite and
    non-negative."""
    import torch

    torch.cuda.synchronize()
    base = _launch_counts({tag: counter})
    single = min(_time_ms(lambda: model(x), reps=10))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    s = x
    start.record()
    for _ in range(SCOPE_STEPS):
        s = model(s)
    end.record()
    end.synchronize()
    launches = _launch_counts({tag: counter}, base)[tag]
    if launches != 11 + SCOPE_STEPS:
        raise AssertionError(f"{tag}: {launches} launches for "
                             f"{11 + SCOPE_STEPS} calls")
    fields = s if isinstance(s, tuple) else s.unbind(0)
    if not all(bool(torch.isfinite(f).all()) for f in fields) or any(
            bool((f < 0).any()) for f in fields[2:]):
        raise AssertionError(f"{tag}: rollout not finite or negative")
    return single, start.elapsed_time(end) / SCOPE_STEPS, launches


def _lib_report(lib_path, kernel):
    """Registers, spills and stack of ``kernel`` from a build's log."""
    from cloudmicrophysics_tpu_torch.kernels import _build

    ptx = _build.ptxas_report((lib_path.parent / "build.log").read_text())
    return next((v for f, v in ptx.items() if kernel in f and "stack" in v),
                {})


def _run_scope(device, K, K2M, Column1MStep, Column2MStep, tps, tv, timing,
               bounds):
    """Phase 18: the K1-K4 scope beyond the default float32 instantaneous
    step. Returns each of K1-K4's ``variants`` (name, ms, bound_ms, bound_by,
    max_abs_err, launches)."""
    import torch

    from cloudmicrophysics_tpu_torch.kernels import _build

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        state_recipe,
        state_recipe_2m,
    )
    from cloudmicrophysics_tpu_torch.models.column import (
        ColumnState,
        ColumnState2M,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        microphysics_1m_params,
        microphysics_2m_params,
    )

    t0 = time.perf_counter()
    print("== 18. K1-K4 scope: linearized_average, every process option, "
          "float64, nlev > 256")
    _f64_rounding(device)
    bits, errs = [0, 0], {}
    _scope_parity(device, K, K2M, tps, tv, bits, errs)
    print(f"  K1-K4 scope bit-identical to the plain step in {bits[0]} of "
          f"{bits[1]} comparisons")
    if bits[0] != bits[1]:
        raise AssertionError("a K1-K4 variant differs from its plain step")

    # ---- full width: the timed configurations ----------------------------
    mp, mp2 = microphysics_1m_params(), microphysics_2m_params()
    f32, f64 = torch.float32, torch.float64
    lin = "linearized_average"
    configs = [   # (tag, kernel, scheme, dtype, ncol, nlev, model keywords)
        ("default float32", "1m", f32, NCOL, NLEV, {}),
        ("linearized_average nsub=1", "1m", f32, NCOL, NLEV,
         dict(mode=lin, nsub=1)),
        ("linearized_average nsub=4", "1m", f32, NCOL, NLEV,
         dict(mode=lin, nsub=4)),
        ("float64", "1m", f64, NCOL, NLEV, {}),
        ("512 levels", "1m", f32, LEVELS_NCOL, 512, {}),
        ("default float32", "2m", f32, NCOL, NLEV, {}),
        ("float64", "2m", f64, NCOL, NLEV, {}),
        ("512 levels", "2m", f32, LEVELS_NCOL, 512, {}),
    ]
    variants = {k: [] for k in ("K1", "K2", "K3", "K4")}
    full_bits = [0, 0]
    states = {}
    for tag, scheme, dtype, ncol, nlev, kw in configs:
        key = (scheme, ncol, nlev)
        if key not in states:
            states.clear()
            torch.cuda.empty_cache()
            recipe = state_recipe if scheme == "1m" else state_recipe_2m
            states[key] = [np.asarray(a) for a in recipe(ncol, nlev)]
        cls = ColumnState if scheme == "1m" else ColumnState2M
        state = cls(*(torch.from_numpy(a).to(dtype).to(device)
                      for a in states[key]))
        if scheme == "1m":
            model = Column1MStep(mp, tps, tv, DT_LIN if kw else DT, DZ,
                                 device=device, **kw)
            mod, kp, ku, variant = K, "K1", "K2", K.variant(mp, kw.get(
                "mode", "instantaneous"))
            pack, unpack = K.pack_state, K.unpack_state
            fused, packed_fused = (K.step_column_1m_fused,
                                   K.step_column_1m_fused_packed)
            block = model.block(dtype)
            path = K.library_path(block, "kernel", variant)
            kernel = "column1m_step_kernel"

            def plain(s, kw=kw, dt=model.dt):
                return K.step_column_1m_plain(s, mp, tps, tv, dt, DZ, **kw)
        else:
            model = Column2MStep(mp2, tps, DT, DZ, device=device)
            mod, kp, ku, variant = K2M, "K3", "K4", K2M._variant(mp2)
            pack, unpack = K2M.pack_state_2m, K2M.unpack_state_2m
            fused, packed_fused = (K2M.step_column_2m_fused,
                                   K2M.step_column_2m_fused_packed)
            block = model.block(dtype)
            path = K2M.library_path(block, variant)
            limited, chen = variant
            kernel = f"column2m_step_kernelILb{limited}ELb{chen}E"

            def plain(s):
                return K2M.step_column_2m_plain(s, mp2, tps, DT, DZ)
        label = f"{'1M' if scheme == '1m' else '2M'} {tag}"
        err_p, err_u = _checked_full((f"{kp} {label}", f"{ku} {label}"),
                                     model, plain, state, full_bits, cls,
                                     pack, unpack)
        packed = pack(state)
        single_p, roll_p, n_p = _timed(f"{kp} {label}", model, packed,
                                       packed_fused)
        del packed
        single_u, roll_u, n_u = _timed(f"{ku} {label}", model, state, fused)
        per_cell, _, ldg = _cell_ops(mod.SOURCE, path, kernel,
                                     tag=f"-{scheme}-{tag.replace(' ', '_')}",
                                     nsub=kw.get("nsub"))
        cells = ncol * nlev
        nbytes = 14 * dtype.itemsize * cells
        bound = _bound(nbytes, per_cell.scale(cells))
        ptx = _lib_report(path, kernel)
        attrs = _build.kernel_attrs(_build_lib(mod, block, variant),
                                    Path(mod.SOURCE).stem, device.index)
        for k, single, roll, n, err in ((kp, single_p, roll_p, n_p, err_p),
                                        (ku, single_u, roll_u, n_u, err_u)):
            default = timing[k][0]
            print(f"  {k} {label} ({ncol}, {nlev}): {single:.6g} ms/step "
                  f"(best single launch), rollout {roll:.6g} ms/step over "
                  f"{SCOPE_STEPS} steps; bound {bound[0]:.6g} ms ({bound[1]}; "
                  f"{per_cell.flops:g} float32, {per_cell.fp64:g} float64, "
                  f"{per_cell.mufu:g} MUFU operations per cell on the least "
                  f"path, {ldg} global loads), {bound[0] / single:.4g} of it; "
                  f"{attrs['registers']} registers, {attrs['local_bytes']} B "
                  f"local memory, ptxas {ptx.get('spill_stores', '?')} B "
                  f"spill stores, {ptx.get('spill_loads', '?')} B spill "
                  f"loads; default float32 {k} in this run {default:.6g} "
                  f"ms/step; {n} launches")
            if bound[0] > single:
                raise AssertionError(f"{k} {label}: bound above the time")
            variants[k].append({
                "name": f"{label} ({ncol}x{nlev})", "ms": single,
                "rollout_ms": roll, "bound_ms": bound[0],
                "bound_by": bound[1], "max_abs_err": err,
                "launches": n, "registers": attrs["registers"],
                "spill_stores": ptx.get("spill_stores")})
        del state
    states.clear()
    torch.cuda.empty_cache()
    if full_bits[0] != full_bits[1]:
        raise AssertionError("a full-width variant differs from its plain step")

    # ---- the option sets at full width -----------------------------------
    state = ColumnState(*(torch.from_numpy(np.asarray(a)).to(
        torch.float32).to(device) for a in state_recipe(NCOL, NLEV)))
    x = K.pack_state(state)
    for label, opts in _scope_options(K):
        m = microphysics_1m_params(**opts)
        model = Column1MStep(m, tps, tv, DT, DZ, device=device)
        block = model.block(torch.float32)
        K._library(block, "kernel", K.variant(m))   # built in phase 2
        path = K.library_path(block, "kernel", K.variant(m))
        per_cell, _, _ = _cell_ops(K.SOURCE, path, "column1m_step_kernel",
                                   tag="-1m-options")
        bound = _bound(14 * 4 * NCOL * NLEV, per_cell.scale(NCOL * NLEV))
        for k, arg, counter in (("K1", x, K.step_column_1m_fused_packed),
                                ("K2", state, K.step_column_1m_fused)):
            single, roll, n = _timed(f"{k} 1M {label}", model, arg, counter)
            print(f"  {k} {label} ({NCOL}, {NLEV}): {single:.6g} ms/step "
                  f"(best single launch), rollout {roll:.6g} ms/step over "
                  f"{SCOPE_STEPS} steps; bound {bound[0]:.6g} ms "
                  f"({bound[1]}); {n} launches; parity max abs err "
                  f"{errs[(k, label)]:.3e} (at {SCOPE_SHAPES})")
            if bound[0] > single:
                raise AssertionError(f"{k} {label}: bound above the time")
            variants[k].append({"name": f"1M {label}", "ms": single,
                                "rollout_ms": roll, "bound_ms": bound[0],
                                "bound_by": bound[1],
                                "max_abs_err": errs[(k, label)],
                                "launches": n})
    del x, state
    torch.cuda.empty_cache()
    timed = {(k, v["name"]) for k, vs in variants.items() for v in vs}
    for (k, name), err in errs.items():   # the cases of the parity only
        label = f"{'1M' if k in ('K1', 'K2') else '2M'} {name}"
        if (k, label) not in timed:
            variants[k].append({"name": f"{label} (parity only)", "ms": None,
                                "bound_ms": None, "max_abs_err": err})

    # ---- the float64 records of the 1M and 2M steps ----------------------
    _scope_records(device, Column1MStep, Column2MStep, tps, tv)
    print(f"== phase 18: {time.perf_counter() - t0:.1f} s")
    return variants


def _build_lib(mod, block, variant):
    """The loaded library of ``mod`` (column1m or column2m) for a block and
    variant."""
    if mod.SOURCE == "column1m.cu":
        return mod._library(block, "kernel", variant)
    return mod._library(block, variant)


def _scope_records(device, Column1MStep, Column2MStep, tps, tv):
    """The float64 K1 and K3 (and K2, K4) against the JAX package's float64
    record of the 1M and 2M steps (``data/column_records_f64.json``), and
    the float32 kernels' per-field error beside the JAX float32 step's."""
    import torch

    import cloudmicrophysics_tpu_torch
    from cloudmicrophysics_tpu_torch.kernels import column1m as K
    from cloudmicrophysics_tpu_torch.kernels import column2m as K2M
    from cloudmicrophysics_tpu_torch.models.column import (
        ColumnState,
        ColumnState2M,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        microphysics_1m_params,
        microphysics_2m_params,
    )

    path = (Path(cloudmicrophysics_tpu_torch.__file__).resolve().parent
            / "data" / "column_records_f64.json")
    record = json.loads(path.read_text())
    print(f"  records ({path.name}): {record['what']}")
    for name, case in record["cases"].items():
        one_m = case["scheme"] == "1m"
        cls = ColumnState if one_m else ColumnState2M
        if one_m:
            model = Column1MStep(microphysics_1m_params(), tps, tv, case["dt"],
                                 record["dz"], device=device,
                                 mode=case["mode"], nsub=case["nsub"])
        else:
            model = Column2MStep(microphysics_2m_params(), tps, case["dt"],
                                 record["dz"], device=device)
        pack = K.pack_state if one_m else K2M.pack_state_2m
        unpack = K.unpack_state if one_m else K2M.unpack_state_2m
        for dtype in (torch.float64, torch.float32):
            outs = {}
            for k, packed in ((("K1", "K3"), True), (("K2", "K4"), False)):
                st = cls(*(torch.tensor(case["state"][f], dtype=dtype,
                                        device=device) for f in cls._fields))
                x = pack(st) if packed else st
                for _ in range(record["steps"]):
                    x = model(x)
                outs[k[0] if one_m else k[1]] = unpack(x) if packed else x
            for k, out in outs.items():
                row = {}
                for f, got in zip(cls._fields, out):
                    want = torch.tensor(case["step"][f], dtype=torch.float64,
                                        device=device)
                    scale = float(want.abs().max())
                    diff = (got.double() - want).abs()
                    row[f] = float(diff.max()) / scale
                    if dtype == torch.float64 and not bool(
                            (diff <= RECORD_ATOL_REL * scale
                             + RECORD_RTOL * want.abs()).all()):
                        raise AssertionError(f"{k} float64 {name}: {f} misses "
                                             f"the record")
                if dtype == torch.float64:
                    print(f"  {k} float64 {name}: matches the JAX float64 "
                          f"record (rtol {RECORD_RTOL}, floor "
                          f"{RECORD_ATOL_REL} of each field); largest error "
                          f"over the field's scale {max(row.values()):.3e}")
                else:
                    jax = case["jax_float32_error"]
                    print(f"  {k} float32 {name}, error against the float64 "
                          f"record over each field's scale (JAX float32 on "
                          f"the CPU in brackets): " + ", ".join(
                              f"{f} {e:.3e} ({jax[f]:.3e})"
                              for f, e in row.items()))



# ---------------------------------------------------------------------------
# K5's whole scope (phase 19)
# ---------------------------------------------------------------------------

# tests/test_torch_p3_ladder.py's tolerance of the port's float64 step
# against the JAX float64 record
P3_RECORD_RTOL, P3_RECORD_ATOL_REL = 1e-9, 1e-12


def _k5_scope_cases(microphysics_2m_params):
    """Phase 19's paths: (tag, parameters, dtype, full-width (ncol, nlev),
    rollout steps, parity states, column stride of the full-width check),
    each parity state (label, kind, ncol, nlev, seed, two tilings): the
    curated ladder states over ``ncol`` columns of 16 levels, or a seeded
    mixed-regime state. The GL-16 paths take phase 10's states; the parity
    column counts of the high orders, and the columns of their full-width
    check, are cut so that their plain steps stay within the phase's time
    (PERF.md §4)."""
    import dataclasses

    import torch

    def mp(order=16, ice_rain_limited=True, **kw):
        m = microphysics_2m_params(with_ice=True, quadrature_order=order,
                                   **kw)
        if not ice_rain_limited:
            m = dataclasses.replace(m, ice=dataclasses.replace(
                m.ice, rain_pdf=dataclasses.replace(m.ice.rain_pdf,
                                                    is_limited=False)))
        return m

    f32, f64 = torch.float32, torch.float64
    full = (P3_NCOL, P3_NLEV)
    # phase 10's states and tilings
    gl16 = [("ladder (640, 16)", "ladder", 640, 16, None, (128, 10)),
            ("mixed (4096, 64)", "mixed", 4096, 64, 3, (128, 2)),
            ("ragged (1000, 40)", "mixed", 1000, 40, 5, (8, 40))]
    return [
        ("GL-40 (ClimaAtmos)", mp(40), f32, full, P3_STEPS,
         [("ladder (160, 16)", "ladder", 160, 16, None, (32, 2)),
          ("mixed (256, 64)", "mixed", 256, 64, 67, (128, 2))], 8),
        ("CG-100 (the reference default)", mp(100), f32, full, 3,
         [("ladder (40, 16)", "ladder", 40, 16, None, (8, 2)),
          ("mixed (64, 64)", "mixed", 64, 64, 67, (64, 2))], 64),
        ("float64 GL-16", mp(16), f64, full, P3_STEPS, gl16, 1),
        ("GL-16 at 4096 x 512", mp(16), f32, (4096, 512), P3_STEPS,
         [("mixed (64, 512)", "mixed", 64, 512, 515, (64, 2)),
          ("mixed (6, 300)", "mixed", 6, 300, 303, (2, 2))], 1),
        ("SlopeConstant GL-16", mp(16, slope_law="constant"), f32, full,
         P3_STEPS, gl16, 1),
        ("NoAspectRatio GL-16", mp(16, aspect_ratio="NoAspectRatio"), f32,
         full, P3_STEPS, gl16, 1),
        ("unlimited ice rain PSD GL-16", mp(16, ice_rain_limited=False),
         f32, full, P3_STEPS, gl16, 1),
    ]


def _k5_scope_parity(K, m, dtype, tag, cases, record, device, tps):
    """Each parity state of a phase-19 path, cold and warm-started from the
    plain step's log lambda, through two tilings: K5 must be bit-identical
    to its plain step (log lambda and every field) and the tilings to each
    other. Returns the comparisons and the largest absolute difference."""
    import torch

    n = 0
    worst = 0.0
    for label, kind, ncol, nlev, seed, tilings in cases:
        st = (_p3_ladder_state(record["states"], ncol // 10, nlev, device)
              if kind == "ladder" else
              _p3_mixed_state(ncol, nlev, device, seed=seed))
        st = type(st)(*(t.to(dtype) for t in st))
        ref, ref_ll = K.step_column_p3_plain(st, m, tps, DT, DZ)
        for start, guess in (("cold", None), ("warm", ref_ll)):
            st_in = st if guess is None else ref
            want, want_ll = (ref, ref_ll) if guess is None else \
                K.step_column_p3_plain(st_in, m, tps, DT, DZ, guess)
            outs = [K.step_column_p3_fused(st_in, m, tps, DT, DZ, guess,
                                           block_cols=bc) for bc in tilings]
            (a, la), (b, lb) = outs
            same = torch.equal(la, want_ll) and all(
                torch.equal(x, y) for x, y in zip(a, want))
            fin = torch.isfinite(want_ll)
            worst = max([worst, float((la - want_ll)[fin].abs().max())
                         if bool(fin.any()) else 0.0] +
                        [float((x - y).abs().max()) for x, y in zip(a, want)])
            n += 1
            if not same:
                raise AssertionError(f"K5 {tag} {label} {start}: differs "
                                     f"from the plain step")
            if not (torch.equal(la, lb) and all(
                    torch.equal(x, y) for x, y in zip(a, b))):
                raise AssertionError(f"K5 {tag} {label} {start}: tilings "
                                     f"{tilings} differ")
    return n, worst


def _k5_full_check(K, m, tps, tag, state, first, first_ll, stride):
    """A phase-19 path's full-width cold step (``first``, ``first_ll``)
    against the plain step on the same inputs, bit for bit: over every
    ``stride``-th column of ``state`` (1: the whole state), the plain step
    in P3_CHUNKS column chunks as phase 11's. Returns the columns checked,
    the largest absolute difference and the plain step's seconds."""
    import torch

    cols = slice(None, None, stride)
    sub = type(state)(*(t[cols].contiguous() for t in state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_ll = K.step_column_p3_plain(sub, m, tps, DT, DZ,
                                         col_chunks=P3_CHUNKS)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got_ll = first_ll[cols]
    same = torch.equal(got_ll, ref_ll) and all(
        torch.equal(a[cols], b) for a, b in zip(first, ref))
    fin = torch.isfinite(ref_ll)
    worst = max([float((got_ll - ref_ll)[fin].abs().max())
                 if bool(fin.any()) else 0.0]
                + [float((a[cols] - b).abs().max())
                   for a, b in zip(first, ref)])
    n = sub.rho.shape[0]
    if not same:
        raise AssertionError(f"K5 {tag}: the full-width cold step differs "
                             f"from the plain step over {n} columns "
                             f"(largest difference {worst:.3e})")
    return n, worst, plain_s


def _k5_scope_record(K, m, device, tps, record):
    """The float64 K5 against the JAX float64 record of the GL-16 step on
    the ladder states, to tests/test_torch_p3_ladder.py's tolerance."""
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

    cols = np.asarray(record["states"], dtype=np.float64).T
    st = ColumnStateP3(*(torch.from_numpy(c[:, None].copy()).to(device)
                         for c in cols))
    out, ll = K.step_column_p3_fused(st, m, tps, record["dt"], record["dz"],
                                     block_cols=10)
    worst = 0.0
    for name, x in zip(out._fields, out):
        want = np.asarray(record["step"][name])
        got = x[:, 0].cpu().numpy()
        atol = P3_RECORD_ATOL_REL * float(np.max(np.abs(want)))
        err = np.abs(got - want)
        worst = max(worst, float(err.max()) / max(float(np.max(np.abs(want))),
                                                  1e-300))
        if not (err <= atol + P3_RECORD_RTOL * np.abs(want)).all():
            raise AssertionError(f"K5 float64: {name} misses the JAX "
                                 f"float64 record")
    want = np.asarray(record["loglambda"])
    got = ll[:, 0].cpu().numpy()
    fin = np.isfinite(want)
    if not ((np.isfinite(got) == fin).all() and np.allclose(
            got[fin], want[fin], rtol=P3_RECORD_RTOL, atol=0.0)):
        raise AssertionError("K5 float64: log lambda misses the JAX float64 "
                             "record")
    print(f"  K5 float64 GL-16 on the ladder states: matches the JAX "
          f"float64 record (rtol {P3_RECORD_RTOL}, floor "
          f"{P3_RECORD_ATOL_REL} of each field); largest error over the "
          f"field's scale {worst:.3e}")


def _run_k5_scope(device, K, ColumnP3Step, microphysics_2m_params, tps,
                  timing):
    """Phase 19: ColumnP3Step through the rest of the JAX step's scope, one
    build of column_p3.cu each (built in phase 2): GL-40, CG-100, float64,
    512 levels, SlopeConstant, NoAspectRatio, the unlimited ice rain PSD.
    Each is held bit for bit to its plain step at small size, driven at
    full width with its launch counters read just before and again just
    after, timed (the step and K5a/K5b/K5c alone) and bounded by its
    operation count. Returns K5's ``variants``."""
    import torch

    from cloudmicrophysics_tpu_torch.models.bench_states import (
        p3_bench_state,
    )

    t0 = time.perf_counter()
    print("== 19. K5 scope: quadrature orders, float64, 512 levels, "
          "SlopeConstant, NoAspectRatio, the unlimited ice rain PSD")
    record = json.loads(
        (Path(__file__).resolve().parent / RECORD).read_text())
    variants, n_all, seconds = [], 0, {}
    for tag, m, dtype, (ncol, nlev), steps, cases, stride in \
            _k5_scope_cases(microphysics_2m_params):
        t1 = time.perf_counter()
        v = K.variant(m, dtype)
        n, worst = _k5_scope_parity(K, m, dtype, tag, cases, record, device,
                                    tps)
        n_all += n
        print(f"  K5 {tag} ({v.tag()}): bit-identical to the plain step in "
              f"{n} of {n} comparisons (" + ", ".join(c[0] for c in cases)
              + ", cold and warm, two tilings each)")
        if dtype == torch.float64:
            _k5_scope_record(K, m, device, tps, record)
        model = ColumnP3Step(m, tps, DT, DZ, device=device)
        state = p3_bench_state(ncol, nlev, device)
        state = type(state)(*(t.to(dtype) for t in state))
        first, first_ll, launches, ms = _drive_p3(model, state, K, tag,
                                                  rollouts=1, nsteps=steps)
        n_cols, err, plain_s = _k5_full_check(K, m, tps, tag, state, first,
                                              first_ll, stride)
        del first
        worst = max(worst, err)
        n_all += 1
        print(f"  K5 {tag}: the full-width cold step bit-identical to the "
              f"plain step over "
              + ("every column" if stride == 1 else
                 f"every {stride}th column ({n_cols} of {ncol})")
              + f" of ({ncol}, {nlev}); plain step {plain_s:.1f} s")
        reps = 2 if v.order > 64 else 4
        kern = min(_time_ms(lambda: model(state, first_ll), reps=reps))
        parts = _k5_parts(K, model, state, first_ll, device, reps=reps)
        ops, _, _ = _k5_ops(K, model, state, first_ll, device, quiet=True)
        total = ops["K5a"] + ops["K5b"] + ops["K5c"]
        cells = ncol * nlev
        nbytes = 24 * dtype.itemsize * cells   # 12 fields read, 12 written
        bound_ms, bound_by = _bound(nbytes, total)
        attrs = _k5_report_row(K, v, tag)
        print(f"  K5 {tag}: {kern:.6g} ms/step (best single step), rollout "
              f"{min(ms):.6g} ms/step; per cell {total.flops / cells:.6g} "
              f"float32, {total.fp64 / cells:.6g} float64 and "
              f"{total.mufu / cells:.6g} MUFU operations; bound "
              f"{bound_ms:.6g} ms ({bound_by}), {bound_ms / kern:.4g} of it; "
              f"default GL-16 float32 K5 in this run {timing['K5'][0]:.6g} "
              f"ms/step; K5 {launches['K5']} launches")
        if bound_ms > kern:
            raise AssertionError(f"K5 {tag}: bound above the time")
        variants.append({
            "name": f"{tag} ({ncol}x{nlev})", "variant": v.tag(), "ms": kern,
            "rollout_ms": min(ms), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": worst,
            "launches": launches["K5"], "full_width_columns": n_cols,
            "full_width_plain_s": plain_s,
            "subkernels": {k: {"ms": parts[k], "launches": launches[k],
                               "bound_ms": _ops_ms(ops[k]),
                               "registers": attrs[k]["registers"],
                               "spill_stores": attrs[k]["spill_stores"],
                               "local_bytes": attrs[k]["local_bytes"],
                               "shared_bytes": attrs[k]["shared_bytes"]}
                           for k in ("K5a", "K5b", "K5c")}})
        del model, state, first_ll
        torch.cuda.empty_cache()
        seconds[tag] = time.perf_counter() - t1
    print(f"  K5 scope bit-identical to the plain step in {n_all} of {n_all} "
          f"comparisons")
    print(f"== phase 19: {time.perf_counter() - t0:.1f} s (by path: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return variants


# ---------------------------------------------------------------------------
# ARG2000 activation (phase 21)
# ---------------------------------------------------------------------------

ARG_SEED = 2**33 + 21           # the seed of phase 21's states


def _arg_state(cfg, ncol, device, dtype):
    """The cell ``arg_mam4``'s seeded state at ``ncol`` columns: its
    distribution and air (``bench_h100/drivers/activation.py``)."""
    from bench_h100.drivers import activation as D
    from bench_h100.reference import activation as R
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolDistribution,
        ModeKappa,
    )

    layout = R.Layout(cfg)
    state = D.make_state(cfg, ncol, ARG_SEED, device, dtype)
    return (layout.distribution(state, ModeKappa, AerosolDistribution),
            layout.air(state))


def _arg_same(label, entry, ad, air, params, bits):
    """Hold both kernels' answers on ``(ad, air)`` to the plain version's
    bit for bit, counting the comparisons in ``bits`` and keeping the
    largest absolute difference in ``entry["max_abs_err"]``; raise on a
    miss."""
    import torch

    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA

    for name in ("N", "M"):
        fn = getattr(AA, f"{name}_activated_per_mode")
        plain = getattr(AA, f"{name}_activated_per_mode_plain")
        got = fn(*params[:1], ad, *params[1:], *air)
        want = plain(*params[:1], ad, *params[1:], *air)
        for i, (a, b) in enumerate(zip(got, want)):
            bits[1] += 1
            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                       float((a - b).abs().max()))
            if torch.equal(a, b):
                bits[0] += 1
                continue
            off = int((a != b).sum())
            rel = float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
            raise AssertionError(f"{label}: {name} mode {i} differs from "
                                 f"the plain version at {off} points "
                                 f"(largest {rel:.3e} of the mode's scale)")
        del got, want
    entry.setdefault("parity", []).append(label)


def _run_activation(device, gpu_line):
    """Phase 21: the ARG2000 kernels (csrc/activation.cu). Builds both
    dtypes and prints each kernel's registers, local memory and resident
    blocks per SM; holds both kernels bit for bit against the plain version
    (the eager code of ops/aerosol_activation.py) on the cell ``arg_mam4``'s
    seeded state at float32 and float64 (4096 and a ragged 37 columns) and
    at the cell's full 777,602 x 72 at float32; then times, at that size by
    CUDA events, each kernel alone (one launch of a built parameter block,
    the best of 10), each entry point with its host side, and the plain
    version, beside each kernel's bytes bound: each field it reads and each
    answer it writes once, at the card's HBM rate. Each launch counter
    must rise by exactly the entry-point calls made at full size. Returns
    the phase's JSON object."""
    import ctypes

    import torch

    from cloudmicrophysics_tpu_torch import trace
    from cloudmicrophysics_tpu_torch.kernels import _build
    from cloudmicrophysics_tpu_torch.kernels import activation as KA
    from cloudmicrophysics_tpu_torch.ops import aerosol_activation as AA
    from cloudmicrophysics_tpu_torch.parameters import (
        AirProperties,
        ThermodynamicsParameters,
    )
    from cloudmicrophysics_tpu_torch.parameters.aerosol import (
        AerosolActivationParameters,
    )

    t_phase = time.perf_counter()
    print("== phase 21: ARG2000 activation kernels")
    params = (AerosolActivationParameters(), AirProperties(),
              ThermodynamicsParameters())
    cfg = json.loads((Path(__file__).resolve().parent / "bench_h100"
                      / "configs" / "atmos_mam4.json").read_text())
    result = {"gpu": gpu_line, "builds": {}}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        ad, air = _arg_state(cfg, 1, device, dtype)
        layout = KA.launch_params(params[0], ad, params[1], params[2], air,
                                  True).layout
        attrs = {k: KA.kernel_attrs(dtype, layout, k == "mass")
                 for k in ("number", "mass")}
        result["builds"][str(dtype)] = {"s": time.perf_counter() - t0,
                                        **attrs}
        print(f"  the cell's layout at {str(dtype)[6:]}: built and loaded in "
              f"{time.perf_counter() - t0:.1f} s; {attrs}")

    bits = [0, 0]
    for dtype in (torch.float32, torch.float64):
        for ncol in (4096, 37):
            ad, air = _arg_state(cfg, ncol, device, dtype)
            _arg_same(f"arg_mam4 ({ncol}, {cfg['nlev']}) {str(dtype)[6:]}",
                      result, ad, air, params, bits)
            del ad, air
    ad, air = _arg_state(cfg, cfg["ncol"], device, torch.float32)
    n = cfg["ncol"] * cfg["nlev"]
    counters = ("launches.arg_number", "launches.arg_mass")
    before = [trace.counter(c) for c in counters]
    calls = {"number": 1, "mass": 1}    # the full-size parity's calls
    _arg_same(f"arg_mam4 ({cfg['ncol']}, {cfg['nlev']}) float32", result, ad,
              air, params, bits)
    print(f"  parity: {bits[0]} of {bits[1]} answers bit-identical to the "
          f"plain version ({', '.join(result['parity'])})")

    hbm = _rates().hbm
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = {}
    for kind, mass in (("number", False), ("mass", True)):
        block, layout, shape, keep = KA.launch_params(
            params[0], ad, params[1], params[2], air, mass)
        lib = KA._library(torch.float32, layout)
        out = torch.empty((len(ad.modes),) + shape, device=device)
        block.out = out.data_ptr()
        reads = sum(1 for f, k in zip(block.f, layout[0])
                    if f.ptr is not None and k == KA.KINDS["full"])
        nbytes = 4 * n * (reads + len(ad.modes))

        def kernel():
            _build.launch(lib.arg2000_launch, int(mass), ctypes.byref(block),
                          device.index, stream)

        entry = getattr(AA, ("M" if mass else "N") + "_activated_per_mode")
        plain = getattr(AA, ("M" if mass else "N")
                        + "_activated_per_mode_plain")

        def call():
            calls[kind] += 1
            entry(params[0], ad, params[1], params[2], *air)

        ms = min(_time_ms(kernel, 10))
        call_ms = min(_time_ms(call, 5))
        plain_ms = min(_time_ms(lambda: plain(params[0], ad, params[1],
                                              params[2], *air), 2))
        bound_ms = nbytes / hbm * 1e3
        rows[kind] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bytes_per_point": nbytes / n,
                      "of_bound": bound_ms / ms}
        print(f"  {kind} kernel at ({cfg['ncol']}, {cfg['nlev']}) float32: "
              f"{ms:.4f} ms alone, {call_ms:.4f} ms through "
              f"{entry.__name__}; bound {bound_ms:.4f} ms ({nbytes / n:g} B "
              f"a point at {hbm:.4g} B/s), {bound_ms / ms:.3f} of it; plain "
              f"version {plain_ms:.2f} ms")
        del out, keep, block
    launches = {kind: trace.counter(c) - b
                for kind, c, b in zip(("number", "mass"), counters, before)}
    if launches != calls:
        raise AssertionError(f"launch counters rose by {launches}, the "
                             f"entry points were called {calls} times")
    print(f"  launches at full size: {launches} (one a call of an entry point)")
    result["rows"] = rows
    result["bits"] = bits
    result["launches"] = launches
    del ad, air
    torch.cuda.empty_cache()
    print(f"== phase 21: {time.perf_counter() - t_phase:.1f} s")
    return result


# ---------------------------------------------------------------------------
# The point-wise fused P3 tendencies (phase 22)
# ---------------------------------------------------------------------------

TEND_SEED = 2**33 + 22          # the seed of phase 22's states


def _tend_state(device, dtype, ncol):
    """The cell ``p3_tend_gl40``'s seeded host state at ``ncol`` columns
    (``bench_h100/drivers/p3_tendencies.py``)."""
    from bench_h100.drivers import p3_tendencies as D

    cfg = json.loads((Path(__file__).resolve().parent / "bench_h100"
                      / "configs" / "climaatmos_2mp3.json").read_text())
    return D.make_state(cfg, ncol, TEND_SEED, device, dtype)


def _run_tendencies(device, gpu_line):
    """Phase 22: the point-wise fused P3 tendencies at the cell
    ``p3_tend_gl40``'s GL-40 (see the module docstring). Returns the
    phase's JSON object."""
    import torch

    from cloudmicrophysics_tpu_torch import trace
    from cloudmicrophysics_tpu_torch.kernels import column_p3 as K5
    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3
    from cloudmicrophysics_tpu_torch.models.tendencies import (
        bulk_microphysics_tendencies,
        bulk_tendencies_2m_plain,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_2m_params,
    )

    t_phase = time.perf_counter()
    print("== phase 22: point-wise fused P3 tendencies (K8)")
    mp = microphysics_2m_params(with_ice=True, quadrature_order=40)
    tps = ThermodynamicsParameters()
    result = {"gpu": gpu_line, "builds": {}, "parity": [],
              "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        attrs = K5.kernel_attrs(K5._library("tend", K5.variant(mp, dtype)))
        result["builds"][str(dtype)[6:]] = {"s": time.perf_counter() - t0,
                                            **attrs}
        print(f"  tendency build GL-40 {str(dtype)[6:]}: built and loaded "
              f"in {time.perf_counter() - t0:.1f} s; {attrs}")

    def args_of(state):
        fields = ColumnStateP3(*state[:11])
        return list(fields) + [K5.loglambda_p3_fused(fields, mp, tps),
                               state.inpc_log_shift]

    def same(label, got, args, cols=None):
        # the plain version over 1024 columns at a time (its node and pair
        # tensors bound the memory)
        if cols is None:
            cols = torch.arange(args[0].shape[0], device=device)
        for lo in range(0, len(cols), 1024):
            c = cols[lo:lo + 1024]
            want = bulk_tendencies_2m_plain(mp, tps, *(a[c] for a in args))
            for name, a, b in zip(got._fields, got, want):
                a = a[c]
                err = float((a - b).abs().max())
                result["max_abs_err"] = max(result["max_abs_err"], err)
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: {name} differs from the "
                                         f"plain version at "
                                         f"{int((a != b).sum())} points")
            del want
        result["parity"].append(label)

    for dtype in (torch.float32, torch.float64):
        for ncol in (4096, 37):
            args = args_of(_tend_state(device, dtype, ncol))
            same(f"p3_tend_gl40 ({ncol}, 63) {str(dtype)[6:]}",
                 bulk_microphysics_tendencies(mp, tps, *args), args)
            del args
    torch.cuda.empty_cache()

    ncol = 86400
    args = args_of(_tend_state(device, torch.float32, ncol))
    names = ("launches.p3_tendencies_fused", "launches.launch_tend_bounds",
             "launches.launch_nodes", "launches.launch_tend_rates",
             "tendencies.points", "tendencies.kernel_points")
    before = [trace.counter(n) for n in names]
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        return bulk_microphysics_tendencies(mp, tps, *args)

    n = args[0].numel()
    eps = torch.finfo(torch.float32).eps
    icy = int(((args[7].clamp_min(0) > eps)
               & (args[8].clamp_min(0) > eps)).sum())
    ice_before = trace.counter("tendencies.ice_points")
    got = call()
    cols = torch.arange(0, ncol, 8, device=device)
    t0 = time.perf_counter()
    same(f"p3_tend_gl40 ({ncol}, 63) float32, every 8th column", got, args,
         cols)
    plain_s = time.perf_counter() - t0
    del got
    call_ms = min(_time_ms(call, 5))
    # the entry point's calls alone: a parity call, a warm-up, five timed
    counted = dict(zip(names, (trace.counter(c) - b
                               for c, b in zip(names, before))))
    want = {k: calls * (n if k.startswith("tendencies.") else 1)
            for k in names}
    if counted != want:
        raise AssertionError(f"counters rose by {counted}, not {want}")
    ice_points = trace.counter("tendencies.ice_points") - ice_before
    if ice_points != calls * icy:
        raise AssertionError(f"tendencies.ice_points rose by {ice_points}, "
                             f"not {calls} x {icy}")
    print(f"  parity: {len(result['parity'])} cases bit-identical to the "
          f"plain version ({', '.join(result['parity'])}); largest "
          f"difference {result['max_abs_err']:g}")

    # each kernel alone, on one scratch record
    lib = K5._library("tend", K5.variant(mp, torch.float32))
    plan = K5.launch_plan(n, 1, mp.ice.quad.n, 1, torch.float32)
    params = K5.kernel_params_p3(mp, tps, device=device)
    flat = ColumnStateP3(*(a.reshape(-1) for a in args[:11]))
    scratch = torch.empty(plan.scratch_shape, device=device)
    out = torch.empty((len(K5.TEND_FIELDS), n), device=device)
    sink = torch.zeros((), dtype=torch.int64, device=device)  # read by none
    parts = {
        "bounds": lambda: K5.launch_tend_bounds(
            lib, flat, args[11], scratch, params, plan, device),
        "nodes": lambda: K5.launch_nodes(lib, flat, scratch, params, plan,
                                         device, sink),
        "rates": lambda: K5.launch_tend_rates(
            lib, flat, args[12], out, scratch, params, K5.warm_variant(mp),
            device),
    }
    part_ms = {k: min(_time_ms(fn, 5)) for k, fn in parts.items()}
    # K5b alone at other ice layouts of the same grid (the bounds kernel
    # first, on each layout's fields)
    nodes_ms = {"cell": part_ms["nodes"]}
    flat_idx = torch.arange(n, device=device)
    for label, where in (("none", flat_idx < 0),
                         ("every other point", flat_idx % 2 == 0),
                         ("every point", flat_idx >= 0)):
        has = (flat.q_ice > 0) & (flat.n_ice > 0)
        zero = torch.zeros((), device=device)
        lay = flat._replace(
            q_ice=torch.where(where, torch.where(has, flat.q_ice, 1e-4),
                              zero),
            n_ice=torch.where(where, torch.where(has, flat.n_ice, 1e5),
                              zero),
            q_rim=torch.where(where & has, flat.q_rim, zero),
            b_rim=torch.where(where & has, flat.b_rim, zero))
        K5.launch_tend_bounds(lib, lay, args[11].reshape(-1), scratch,
                              params, plan, device)
        nodes_ms[label] = min(_time_ms(lambda: K5.launch_nodes(
            lib, lay, scratch, params, plan, device, sink), 5))
        del lay
    result["nodes_ms_by_ice"] = nodes_ms
    result["ice_share"] = icy / n
    solve_ms = min(_time_ms(lambda: K5.loglambda_p3_fused(
        ColumnStateP3(*args[:11]), mp, tps, args[11], params=params), 5))
    result["launches"] = {k.split(".", 1)[1]: v for k, v in counted.items()
                          if k.startswith("launches.launch_")}
    result.update(ms=call_ms, plain_ms=plain_s * 1e3 * 8,
                  solve_ms=solve_ms, points=n,
                  subkernels=[{"name": k, "ms": v}
                              for k, v in part_ms.items()])
    print(f"  at ({ncol}, 63) float32: the call {call_ms:.3f} ms "
          f"(bounds {part_ms['bounds']:.3f}, nodes {part_ms['nodes']:.3f}, "
          f"rates {part_ms['rates']:.3f} ms alone); the host's shape solve "
          f"(K5a, warm) {solve_ms:.3f} ms; the plain version {plain_s:.1f} s "
          f"over an eighth of the columns; counters over the entry point's "
          f"{calls} calls {counted}, tendencies.ice_points {ice_points} "
          f"(share {icy / n:.6f})")
    print(f"  K5b alone by ice layout (ms): {nodes_ms}")
    del args, flat, scratch, out
    torch.cuda.empty_cache()
    if os.environ.get("K5_PARENT_TREE"):
        result["column_sass"] = _column_sass_ab(os.environ["K5_PARENT_TREE"])
    print(f"== phase 22: {time.perf_counter() - t_phase:.1f} s")
    return result


def _column_sass(root, order):
    """The SASS of the column build (no ``-DK5_TEND``) of ``column_p3.cu``
    at ``order`` in the checkout ``root``, built there by a process of its
    own (``opcount.disassemble``), without what names the source rather
    than the code: the line table's ``//##`` lines and the hash of the
    source's text that nvcc writes into the names of its anonymous
    namespace (``_GLOBAL__N__<hash>_``, ``_INTERNAL_<hash>_``)."""
    import re

    from cloudmicrophysics_tpu_torch.kernels import opcount

    code = ("import sys; sys.path.insert(0, '.'); "
            "from cloudmicrophysics_tpu_torch.kernels import column_p3 as K; "
            f"print(K.library_path('kernel', K.Variant(order={order})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=900)
    sass = opcount.disassemble(Path(root) / out.stdout.strip().splitlines()[-1])
    sass = "\n".join(line for line in sass.splitlines() if "//##" not in line)
    return re.sub(r"(_GLOBAL__N__|_INTERNAL_)[0-9a-f]{8}_", r"\1", sass)


def _column_sass_ab(parent):
    """Whether the column build's SASS at GL-16 and GL-40 is, text for
    text, that of the checkout ``parent``; raises where it is not."""
    here = Path(__file__).resolve().parent
    out = {}
    for order in (16, 40):
        mine = _column_sass(here, order)
        theirs = _column_sass(Path(parent).resolve(), order)
        row = {"lines": mine.count("\n"), "same_as_parent": mine == theirs}
        if mine != theirs:
            pairs = [(a, b) for a, b in zip(mine.splitlines(),
                                            theirs.splitlines()) if a != b]
            row["lines_differing"] = len(pairs), pairs[:4]
        print(f"  column build GL-{order} SASS against {parent}'s: {row}")
        out[f"GL-{order}"] = row
    if not all(r["same_as_parent"] for r in out.values()):
        raise AssertionError(f"the column build's SASS differs from "
                             f"{parent}'s: {out}")
    return out


# ---------------------------------------------------------------------------
# The examples (phase 20)
# ---------------------------------------------------------------------------

EXAMPLES_RECORD = "cloudmicrophysics_tpu_torch/data/examples_f64.json"
EX_RTOL, EX_FLOOR = 1e-6, 1e-12     # tests/test_torch_examples_parcel.py
EX_SEEDS = (0, 1, 2, 3)             # of the runs that draw
# the pairs of summary numbers between which a content or number moves:
# each one's absolute floor is EX_FLOOR of the larger of the two
PHASE_PAIRS = (("q_liq", "q_ice"), ("N_liq", "N_ice"))
SQUALL_FULL = dict(ncol=P3_NCOL, nlev=P3_NLEV, dz=125.0, order=16)


def _ex_errors(got, want, path, out):
    """Append ``(path, relative error, within tolerance)`` for every number
    of a nested record of an example: rtol EX_RTOL, with an absolute floor
    of EX_FLOOR of the condensate present for a summary's liquid and ice
    contents and numbers and of S_l for the peak supersaturation S_l - 1;
    integers and flags exactly. A number at or below
    its floor reports relative error 0."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {set(got) ^ set(want)}")
        floors = {k: EX_FLOOR * max(abs(want[a]), abs(want[b]))
                  for a, b in PHASE_PAIRS if a in want for k in (a, b)}
        if "peak_S" in want:    # S_l - 1: the floor of S_l
            floors["peak_S"] = EX_FLOOR * (1 + abs(want["peak_S"]))
        for k in want:
            if k in floors:
                d, w = abs(got[k] - want[k]), abs(want[k])
                out.append((f"{path}.{k}", d / w if w > floors[k] else 0.0,
                            d <= floors[k] + EX_RTOL * w))
            else:
                _ex_errors(got[k], want[k], f"{path}.{k}", out)
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _ex_errors(g, w, f"{path}[{i}]", out)
    elif isinstance(want, (bool, int)):
        out.append((path, 0.0 if got == want else float("inf"), got == want))
    else:
        d, w = abs(got - want), abs(want)
        out.append((path, d / w if w else d, d <= EX_RTOL * w))
    return out


def _in_band(got, band, path, out):
    """Each number within the range of the record's 16 JAX keys, widened
    by half of it on either side (as tests/test_torch_examples_random.py);
    the relative error reported is the distance outside the range."""
    for k, (_, _, lo, hi) in band.items():
        pad = 0.5 * (hi - lo)
        v = got[k]
        out_by = max(lo - pad - v, v - hi - pad, 0.0)
        out.append((f"{path}.{k}", out_by / max(abs(hi), abs(lo), 1e-300),
                    out_by == 0.0))


def _squall_error(got, want):
    """tests/test_torch_examples.squall_error over every cell of one
    column: per field the largest absolute difference over the field's
    largest magnitude."""
    return {name: float(np.max(np.abs(g - w))
                        / max(float(np.max(np.abs(w))), 1e-300))
            for name, g, w in zip(got[0]._fields, got[0], want[0])}


def _same_columns(*tensors):
    """Every column of every tensor bit-equal to column 0."""
    return all(bool((t == t[:1]).all()) for t in tensors)


def _squall_vs_plain(device, SQ, step_column_p3, mp):
    """K5 against the port's plain step on the card at every step of the
    script's rollout (256 x 64, GL-8, float32), each carrying its own log
    lambda as the next step's guess: bit for bit, in every field."""
    import torch

    st = SQ.column_state(256, 64, 250.0, device)
    fused = SQ.stepper(mp, 2.0, 250.0, device)
    a, ga, b, gb = st, None, st, None
    for i in range(120):
        a, ga = fused(a, ga)
        b, gb = step_column_p3(b, mp, SQ.TPS, 2.0, 250.0, gb)
        same = torch.equal(ga, gb) and all(torch.equal(x, y)
                                           for x, y in zip(a, b))
        if not same:
            bad = [f for f, x, y in zip(a._fields, a, b)
                   if not torch.equal(x, y)]
            raise AssertionError(f"squall step {i}: K5 differs from the "
                                 f"plain step in {bad or ['log lambda']}")
    print("  squall (256, 64) GL-8: K5 bit-identical to the plain step at "
          "every one of 120 steps, every field and log lambda")
    return 120


def _squall_vs_record(device, SQ, record, microphysics_2m_params):
    """K5 one step from each state of the record's JAX float32 rollout,
    tiled to the configuration's width: every column bit-equal to column
    0, and per field at most twice JAX float32's own error against JAX's
    float64 step plus 1e-6, over every cell. Returns
    the largest ratio of K5's error to that bound."""
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

    worst = 0.0
    for cfg, ncol in (("small", 256), ("full", SQUALL_FULL["ncol"])):
        rec = record["squall"][cfg]
        mp = microphysics_2m_params(with_ice=True,
                                    quadrature_order=rec["order"])
        step = SQ.stepper(mp, rec["dt"], rec["dz"], device)
        nlev = rec["nlev"]

        def tile(v):
            return torch.tensor(v, dtype=torch.float32, device=device) \
                .expand(ncol, nlev).contiguous()

        for k, inp, want, jerr in zip(rec["input_steps"], rec["inputs"],
                                      rec["f64_step"],
                                      rec["jax_float32_error"]):
            st = ColumnStateP3(*(tile(inp["state"][f])
                                 for f in ColumnStateP3._fields))
            g = None if inp["guess"] is None else tile(inp["guess"])
            out, ll = step(st, g)
            if not _same_columns(*out, ll):
                raise AssertionError(f"squall {cfg} step {k}: columns "
                                     f"differ from column 0")
            got = (ColumnStateP3(*(t[0].double().cpu().numpy()
                                   for t in out)),
                   ll[0].double().cpu().numpy())
            ref = (ColumnStateP3(*(np.asarray(want["state"][f])
                                   for f in ColumnStateP3._fields)),
                   np.asarray(want["loglambda"]))
            for f, e in _squall_error(got, ref).items():
                bound = 2 * jerr[f] + 1e-6
                worst = max(worst, e / bound)
                if e > bound:
                    raise AssertionError(
                        f"squall {cfg} step {k}: {f} error {e:.3e} above "
                        f"2 x JAX float32's {jerr[f]:.3e} + 1e-6")
        print(f"  squall {cfg} ({ncol}, {nlev}) GL-{rec['order']}: K5 one "
              f"step from each of the JAX rollout's states "
              f"{rec['input_steps']}: columns bit-equal, error within 2 x "
              f"JAX float32's + 1e-6 in every field")
    print(f"  squall: largest ratio of K5's error to its bound {worst:.4g}")
    return worst


def _run_examples(device, K5, gpu_line):
    """Phase 20: the twelve examples on the card through their ``run()``,
    against the JAX record; the squall's K5 against the plain step and the
    record; the squall at full width. Returns the phase's JSON entries and
    K5's launches on its main path."""
    import importlib

    import torch

    from cloudmicrophysics_tpu_torch.examples import NAMES
    from cloudmicrophysics_tpu_torch.examples import column_squall_p3 as SQ
    from cloudmicrophysics_tpu_torch.models.column import step_column_p3
    from cloudmicrophysics_tpu_torch.parameters import microphysics_2m_params

    t_phase = time.perf_counter()
    print("== 20. the examples on the card, against the JAX record "
          f"({EXAMPLES_RECORD})")
    record = json.loads(
        (Path(__file__).resolve().parent / EXAMPLES_RECORD).read_text())
    torch.cuda.empty_cache()
    # kernel parity first: these launches are not the main path's
    mp8 = microphysics_2m_params(with_ice=True, quadrature_order=8)
    _squall_vs_plain(device, SQ, step_column_p3, mp8)
    squall_ratio = _squall_vs_record(device, SQ, record,
                                     microphysics_2m_params)

    counted = {"K5": K5.step_column_p3_fused, "K5a": K5.launch_solve,
               "K5b": K5.launch_nodes, "K5c": K5.launch_epilogue}
    torch.cuda.synchronize()
    base = _launch_counts(counted)
    entries = []
    for name in NAMES:
        mod = importlib.import_module(f"cloudmicrophysics_tpu_torch."
                                      f"examples.{name}")
        kw = record["cut_kwargs"].get(name, {})
        seeded = "seed" in mod.run.__code__.co_varnames
        errs = []
        t0 = time.perf_counter()
        steps = 0
        for seed in (EX_SEEDS if seeded else (None,)):
            out = mod.run(device, **kw, **({"seed": seed} if seeded else {}))
            steps += out["steps"]
            if name == "column_squall_p3":
                continue
            want = record["cut" if kw else "full"][name]
            bands = record["bands"].get(name, {})
            if name == "box_alpert_knopf_2016":
                _in_band(out, bands, f"{name}[seed {seed}]", errs)
                _ex_errors({k: out[k] for k in want if k not in bands},
                           {k: want[k] for k in want if k not in bands},
                           name, errs)
                continue
            for k in want:
                if k in bands:
                    _in_band(out[k], bands[k], f"{name}.{k}[seed {seed}]",
                             errs)
                else:
                    _ex_errors(out[k], want[k], f"{name}.{k}", errs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the squall's run() raises on a non-finite field; its rollout is
        # held step by step above, not against the record
        bad = [p for p, _, ok in errs if not ok]
        worst = max((e for _, e, _ in errs), default=None)
        entries.append({"name": name, "steps": steps, "seconds": seconds,
                        "steps_per_s": steps / seconds,
                        "max_rel_err": worst, "pass": not bad,
                        **({"cut": kw} if kw else {}),
                        **({"seeds": list(EX_SEEDS)} if seeded else {})})
        print(f"  {name}{' ' + str(kw) if kw else ''}: {steps} steps in "
              f"{seconds:.3f} s, {steps / seconds:.1f} steps/s; "
              + ("finite (its steps are held above)" if worst is None else
                 f"largest relative error against the record {worst:.3e}")
              + (f" over seeds {list(EX_SEEDS)} (band)" if seeded else "")
              + ("" if not bad else f"; FAILED: {bad[:6]}"))
        if bad:
            raise AssertionError(f"{name}: {bad[:6]} outside the record's "
                                 f"tolerance")

    # the squall at full width, through the module's own stepper
    cfg = SQUALL_FULL
    mp16 = microphysics_2m_params(with_ice=True,
                                  quadrature_order=cfg["order"])
    state = SQ.column_state(cfg["ncol"], cfg["nlev"], cfg["dz"], device)
    step = SQ.stepper(mp16, 2.0, cfg["dz"], device)
    ms, (final, ll, rows) = _event_ms(
        lambda: SQ.rollout(state, step, 120, cfg["dz"]))
    launches = _launch_counts(counted, base)
    squall_steps = 120 + entries[-1]["steps"]
    if set(launches.values()) != {squall_steps}:
        raise AssertionError(f"squall: launch counts {launches} != the "
                             f"{squall_steps} steps driven")
    for f, x in zip(final._fields, final):
        if not bool(x.isfinite().all()):
            raise AssertionError(f"full-width squall: {f} not finite")
    if not _same_columns(*final, ll):
        raise AssertionError("full-width squall: columns differ from "
                             "column 0")
    lwp, rwp, iwp = SQ.water_paths(final, cfg["dz"])
    ens = record["squall"]["full"]["ensemble_iwp"]
    print(f"  squall ({cfg['ncol']}, {cfg['nlev']}) GL-{cfg['order']} "
          f"float32, 120 steps: {ms / 120:.6g} ms/step (CUDA events, the "
          f"table's 7 host reads included), every column bit-equal to "
          f"column 0, every field finite; column 0 LWP {lwp:.6g} RWP "
          f"{rwp:.6g} IWP {iwp:.6g} kg/m^2 (JAX's 16 one-ulp-perturbed "
          f"columns: {min(ens):.6g} to {max(ens):.6g})")
    print(f"  launches on the examples' path (counted from before the "
          f"examples to after the full-width squall): {launches}")
    entries.append({"name": "column_squall_p3 (16384x128 GL-16)",
                    "steps": 120, "seconds": ms / 1e3,
                    "steps_per_s": 120 / (ms / 1e3), "ms_per_step": ms / 120,
                    "max_rel_err": None, "k5_error_over_bound": squall_ratio,
                    "pass": True,
                    "iwp": iwp, "jax_ensemble_iwp": [min(ens), max(ens)]})
    del state, final, ll
    torch.cuda.empty_cache()
    print(f"== phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"gpu": gpu_line, "examples": entries}, launches


if __name__ == "__main__":
    sys.exit(main())
