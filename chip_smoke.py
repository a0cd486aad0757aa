"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused 1M, 2M and 2M + P3 column kernels from
``cloudmicrophysics_tpu_torch/kernels/csrc`` with ``nvcc`` (one compiler per
source, started together, into the package's ignored ``build/`` directory),
then, failing at the first phase that does not hold:

1. prints the toolchain (GPU name and power limit, torch, CUDA, nvcc,
   whether triton imports);
2. prints each build's time and the compiler's register/spill report;
   K1/K2's and K3/K4's registers, spills and resident blocks per SM; and
   for K5's three kernels (K5a solve, K5b node pass at each order, K5c
   epilogue) their registers, spills, stack frame and local memory per
   thread (each source is built as its kernel and its probe, ``BUILDS`` in
   ``kernels/column1m.py``, ``column2m.py`` and ``column_p3.py``, and
   ``column2m.cu``, whose parameters and variant are compiled in, once for
   each 2M parameter block and variant phase 7 runs: default,
   ``is_limited=False``, Chen 2022);
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
6. times a plain streaming pass over the packed state (``torch.mul``, the
   memory roof the kernel is quoted against) and measures the device's idle
   share over 10 fused steps with ``torch.profiler``;
7. compares both 2M warm-rain kernel entry points (packed, K3, and
   unpacked, K4) with their plain versions at (4096, 128), a ragged
   (1000, 40), (64, 512), the in-kernel ``q_tot`` affine,
   ``is_limited=False``, ``rain_velocity="chen2022"`` and the benchmark's
   uniform 2M state, under the same tolerance, with two tilings agreeing
   bit for bit, counts the comparisons that are bit-identical to the plain
   step and fails unless all are;
8. drives the 2M path at full width: ``Column2MStep`` over a packed
   (7, 524288, 128) float32 2M state, one step on the unpacked state and
   three timed 30-step rollouts with the same ``q_tot`` affine schedule,
   with the same checks, holding the unpacked step against the plain
   version bit for bit;
9. times K3 and K4 and their plain versions at that size, holds one
   full-size packed step against the plain version bit for bit, prints
   K3's stage split from its probe build (as K1's in phase 5), quotes K3
   against the streaming pass of phase 6, counts the plain step's device
   kernels and measures the device's idle share over 10 K3 steps;
10. holds K5a's log lambda against the plain shape solve on the ladder
    states, cold and warm-started, bit for bit; then compares the 2M + P3
    step (K5: K5a, K5b, K5c) with its plain version at quadrature
    orders 4, 8 and 16 on the 10 curated ladder states tiled over
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
    column chunk), quotes K5 against the streaming pass of phase 6, and
    counts K5's operations (kernels/opcount.py: the probe build's region
    counts on this state times each region's operations on its least path
    through the timed build's SASS; the probe's warp counts give each
    region's SIMT efficiency and each kernel's share of the warp issue
    rate) and K1-K4's (their ``cell_step`` on its least path, once per
    cell, with the global loads among its instructions, which must be
    none: their parameters are literals), for each kernel's bound: the
    larger of its bytes over 3.35 TB/s and its operations' time, float32
    operations over 67 TFLOP/s or MUFU operations over 16 per SM per clock
    (132 SMs at 1.98 GHz), the larger.
    Fails if a bound exceeds the kernel's time. The SASS and the probe's
    counts go to ``kernels/build/``.

The line before the last is a JSON object with one entry per kernel (K5's
with its three kernels under ``subkernels``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits with a
non-zero code and prints no result.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

NCOL, NLEV = 524288, 128      # the size the repo's benchmark has always run
DT, DZ = 1.0, 100.0
N_STEPS, N_ROLLOUTS = 30, 3   # the benchmark's rollout length and count
RTOL, ATOL = 2e-5, 2e-9       # the Pallas kernel's contract (tests/test_kernels.py)
AFFINE = (1.0 + 1e-4 * 5, 1e-9 * 6)
# the H100 SXM's published HBM rate and float32 rate outside the tensor
# cores (an FMA two operations); its special-function units' rate, 16
# results per SM per clock (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0); and its warp instruction issue rate, one
# per scheduler per clock: 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
MUFU_PER_S = 132 * 16 * 1.98e9
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9


def _ops_ms(tally):
    """Least ms of an operation count (:class:`opcount.Tally`): its float32
    operations at the float32 rate or its special-function operations at
    theirs, the larger."""
    return max(tally.flops / FP32_PER_S, tally.mufu / MUFU_PER_S) * 1e3


def _bound(nbytes, tally):
    """(ms, "bytes" or "operations"): the larger of the bytes' time at the
    HBM rate and the operations' time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, _ops_ms(tally)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _gpu_line():
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def _state_recipe(ncol, nlev, seed=0):
    """The benchmark's state (``__graft_entry__._build``), in numpy."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    yield np.linspace(1.2, 0.4, nlev)[None, :] * ones
    yield np.linspace(300.0, 220.0, nlev)[None, :] * ones
    for scale in (1e-2, 1e-3, 5e-4, 5e-4, 5e-4):
        yield scale * rng.random(shape)


def _device_state(ncol, nlev, device, seed=0):
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnState

    return ColumnState(*(
        torch.from_numpy(a.astype(np.float32)).to(device)
        for a in _state_recipe(ncol, nlev, seed)))


def _state_recipe_2m(ncol, nlev, seed=0):
    """The 2M state: the 1M recipe's rho and T profiles, random contents
    and numbers, in numpy."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    ones = np.ones((ncol, 1))
    yield np.linspace(1.2, 0.4, nlev)[None, :] * ones
    yield np.linspace(300.0, 220.0, nlev)[None, :] * ones
    for scale in (1e-2, 1e-3, 1e8, 5e-4, 1e6):
        yield scale * rng.random(shape)


# the TPU benchmark's uniform 2M state (benchmarks/bench_suite.py:150-153)
UNIFORM_2M = (1.1, 288.0, 6e-3, 1e-3, 9e7, 5e-4, 9e5)
# the 2M parameter options phase 7 runs, each one more build of column2m.cu
BLOCKS_2M = (("default", {}), ("is_limited=False", {"is_limited": False}),
             ("rain_velocity=chen2022", {"rain_velocity": "chen2022"}))


def _device_state_2m(ncol, nlev, device, seed=0, uniform=False):
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnState2M

    arrays = ([np.full((ncol, nlev), v) for v in UNIFORM_2M] if uniform
              else _state_recipe_2m(ncol, nlev, seed))
    return ColumnState2M(*(torch.from_numpy(a.astype(np.float32)).to(device)
                           for a in arrays))


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
    """Whether two ColumnStates are equal bit for bit; prints the cells
    that differ per field when not, and adds the outcome to ``tally``
    (``[identical, compared]``)."""
    import torch

    diff = {n: int((a != b).sum()) for n, a, b in zip(ref._fields, out, ref)
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
    counters set to 0 just before and read just after. Checks that the
    counters (``names``: packed, unpacked kernel) equal the steps driven
    and that the results are finite and non-negative; prints ms/step and
    grid-points/s. Returns the first step, the packed state and the
    launch counts."""
    import torch

    torch.cuda.synchronize()
    fused.launches = packed_fused.launches = 0
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
    launches = {k_packed: packed_fused.launches, k_unpacked: fused.launches}
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


def _k5_build_report(K5):
    """Phase 2 for K5: each kernel's registers, local memory and static
    shared memory (CUDA runtime) and its spills and stack frame (the
    compiler's report). Returns the runtime's numbers per order."""
    from cloudmicrophysics_tpu_torch.kernels import _build

    log = (K5.library_path().parent / "build.log").read_text()
    report = _build.ptxas_report(log)
    lib = K5._library()
    attrs = {order: K5.kernel_attrs(lib, order) for order in K5.ORDERS}
    names = {"K5a": "column_p3_solve_kernel",
             "K5c": "column_p3_epilogue_kernelILb1ELb0E"}
    rows = [("K5a", "all orders", names["K5a"], attrs[16]["K5a"])]
    rows += [("K5b", f"GL-{o}", f"column_p3_nodes_kernelILi{o}E",
              attrs[o]["K5b"]) for o in K5.ORDERS]
    rows += [("K5c", "limited rain PSD, SB2006 fall speeds", names["K5c"],
              attrs[16]["K5c"])]
    for key, tag, part, a in rows:
        ptx = next((v for f, v in report.items() if part in f), {})
        print(f"  {key} ({tag}): {a['registers']} registers, "
              f"{a['local_bytes']} B local memory per thread, "
              f"{a['shared_bytes']} B static shared memory; ptxas: "
              f"{ptx.get('spill_stores', '?')} B spill stores, "
              f"{ptx.get('spill_loads', '?')} B spill loads, "
              f"{ptx.get('stack', '?')} B stack frame")
    for part in ("logLdivN", "gamma_inc_inv4"):
        ptx = next((v for f, v in report.items()
                    if part in f and "registers" not in v), None)
        if ptx:
            print(f"  {part} (called by K5a): {ptx['stack']} B stack frame, "
                  f"{ptx['spill_stores']} B spill stores")
    return attrs


def _stages(key, K, lib, packed):
    """A kernel's stage split from its probe build ``lib`` (``-DK1_PROBE``
    of ``kernels/column1m.py`` or ``-DK3_PROBE`` of ``column2m.py``, the
    module ``K``) on ``packed``: each stage's share of the warps'
    ``clock64()`` cycles and its cycles per warp pass, from one launch
    after a warm-up."""
    import torch

    from cloudmicrophysics_tpu_torch.models.column import _block_cols

    probe_set = f"{Path(K.SOURCE).stem}_probe_set"
    sums = torch.zeros(len(K.PROBE_STAGES) + 1, dtype=torch.int64,
                       device=packed.device)
    err = getattr(lib, probe_set)(sums.data_ptr(), packed.device.index)
    if err:
        raise RuntimeError(f"{probe_set}: CUDA error {err}")

    def run():
        K.launch_packed(lib, packed, DT, DZ,
                        _block_cols(packed.shape[1], K.BLOCK_COLS),
                        q_tot_affine=AFFINE)

    run()
    torch.cuda.synchronize()
    sums.zero_()
    ms = _time_ms(run, reps=1, warmup=0)[0]
    *cycles, passes = sums.tolist()
    total = sum(cycles)
    print(f"  {key} probe build (clock64 per warp, one launch, {ms:.6g} ms): "
          f"{passes} warp passes; per stage share of the cycles and cycles "
          f"per warp pass: " + ", ".join(
              f"{s} {c / total:.4f} ({c / passes:.6g})"
              for s, c in zip(K.PROBE_STAGES, cycles)))
    return dict(zip(K.PROBE_STAGES, cycles))


def _cell_ops(source, library, kernel):
    """Operations per cell of ``kernel`` in the ``library`` built from
    ``csrc/<source>``: its ``cell_step`` (run once per cell) on its least
    path (kernels/opcount.py), every arm's instructions, and the global
    loads (``LDG``) among them. Writes the SASS to
    ``kernels/build/<source>.sass.gz``."""
    import gzip

    from cloudmicrophysics_tpu_torch.kernels import _build, opcount

    src = (_build.CSRC_DIR / source).read_text()
    sites = {"cell_step": opcount.function_block(src, "cell_step")}
    sass = opcount.disassemble(library)
    (_build.BUILD_DIR / f"{Path(source).stem}.sass.gz").write_bytes(
        gzip.compress(sass.encode()))
    instrs = [i for i in opcount.parse_sass(sass) if kernel in i.function]
    per_cell, every_arm = opcount.call_site_tally(instrs, sites, source,
                                                  "cell_step")
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
    jobs += [(f"{K5.SOURCE} ({b}: {' '.join(K5.BUILDS[b])})",
              lambda b=b: K5._library(b)) for b in K5.BUILDS]
    # column2m.cu: each 2M parameter block and variant phase 7 runs, and the
    # default one's probe
    blocks2m = [(tag, K2M.kernel_params_2m(m, tps), K2M._variant(m), b)
                for tag, opts in BLOCKS_2M
                for m in [microphysics_2m_params(**opts)]
                for b in (K2M.BUILDS if not opts else ("kernel",))]
    jobs += [(f"{K2M.SOURCE} ({tag}, {b}: {' '.join(K2M.BUILDS[b])})",
              lambda p=p, v=v, b=b: K2M._library(p, v, b))
             for tag, p, v, b in blocks2m]
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
        st = _device_state(ncol, nlev, device, seed=7)
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
    state = _device_state(NCOL, NLEV, device)
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

    # ---- 6. memory roof and idle share -------------------------------------
    print(f"== fused step against a streaming pass over ({len(packed)}, "
          f"{NCOL}, {NLEV}) float32")
    buf = torch.empty_like(packed)
    copy_ms = min(_time_ms(lambda: torch.mul(packed, 1.0 + 1e-6, out=buf),
                           reps=10))
    nbytes = 2 * packed.numel() * packed.element_size()   # read + write
    print(f"  streaming pass (torch.mul): {copy_ms:.6g} ms, "
          f"{nbytes / copy_ms / 1e6:.6g} GB/s")
    print(f"  K1: {timing['K1'][0]:.6g} ms/step, "
          f"{nbytes / timing['K1'][0] / 1e6:.6g} GB/s, "
          f"{copy_ms / timing['K1'][0]:.4g} of the streaming pass's rate")
    idle = _idle_share(lambda: model(packed, q_tot_affine=AFFINE), calls=10)
    print("  device idle share over 10 K1 steps (torch.profiler): "
          + ("not measured, the profiler saw no device time" if idle is None
             else f"{idle:.6g}"))
    del buf, state, packed, model

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
    bounds = {}
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
        for k in ks:
            bounds[k] = bound
            print(f"  {k}: per cell {per_cell.flops:g} float32 operations, "
                  f"{per_cell.mufu:g} MUFU, {per_cell.issued:g} instructions "
                  f"issued ({every_arm:g} with every arm, {ldg} of them "
                  f"global loads); bound "
                  f"{bound[0]:.6g} ms ({bound[1]}; bytes "
                  f"{14 * 4 * cells / HBM_BYTES_PER_S * 1e3:.4g} ms, float32 "
                  f"{per_cell.flops * cells / FP32_PER_S * 1e3:.4g} ms, MUFU "
                  f"{per_cell.mufu * cells / MUFU_PER_S * 1e3:.4g} ms), kernel "
                  f"{timing[k][0]:.6g} ms, {bound[0] / timing[k][0]:.4g} of "
                  f"the bound; issue {per_cell.issued * cells / 32 / WARP_ISSUE_PER_S * 1e3:.4g}"
                  f" ms at one warp instruction per scheduler per clock")
    bounds["K5"] = (k5["bound_ms"], k5["bound_by"])
    over = [k for k in bounds if bounds[k][0] > timing[k][0]]
    if over:
        raise AssertionError(f"{over}: bound above the measured time, so the "
                             f"count is no lower bound")

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
         "library_ms": None}
        for k, fn, src, tpu in entries]
    kernels[-1]["subkernels"] = k5["subkernels"]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_2m(device, K, Column2MStep, microphysics_2m_params, tps, copy_ms):
    """Phases 7-9: the 2M warm-rain kernels K3 (packed) and K4 (unpacked)
    against their plain versions, and the 2M path at full width. Returns
    the launch counts of the main path, the largest errors and the
    (kernel, plain) times."""
    import torch

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
        st = _device_state_2m(ncol, nlev, device, seed=7, uniform=uniform)
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
    state = _device_state_2m(NCOL, NLEV, device)
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
            packed)
    nbytes = 2 * packed.numel() * packed.element_size()   # read + write
    print(f"  K3: {timing['K3'][0]:.6g} ms/step, "
          f"{nbytes / timing['K3'][0] / 1e6:.6g} GB/s, "
          f"{copy_ms / timing['K3'][0]:.4g} of the streaming pass's rate")
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
# the TPU benchmark's P3 column state (benchmarks/bench_suite.py:220-223)
BENCH_P3 = (1.1, 263.0, 6e-3, 1e-3, 9e7, 5e-4, 9e5, 5e-4, 1e5, 1e-4, 2e-7)
RECORD = "cloudmicrophysics_tpu_torch/data/p3_ladder_gl16.json"


def _p3_state(arrays, device):
    import torch

    from cloudmicrophysics_tpu_torch.models.column import ColumnStateP3

    return ColumnStateP3(*(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                           for a in arrays))


def _p3_bench_state(ncol, nlev, device, seed=0):
    """The P3 bench state with rho 1.2 -> 0.5 and T 270 -> 250 K over the
    levels and a seeded +-50 % jitter of every content and number."""
    rng = np.random.default_rng(seed)
    ones = np.ones((ncol, 1))
    arrays = [np.linspace(1.2, 0.5, nlev)[None] * ones,
              np.linspace(270.0, 250.0, nlev)[None] * ones]
    arrays += [v * (1 + 0.5 * (2 * rng.random((ncol, nlev)) - 1))
               for v in BENCH_P3[2:]]
    return _p3_state(arrays, device)


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
    runs = [(order, {}) for order in K.ORDERS] + [
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
    state = _p3_bench_state(P3_NCOL, P3_NLEV, device)
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
          f"{rate / copy_gbs:.4g} of the streaming pass's rate "
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
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4g} ms, float32 "
          f"{total.flops / FP32_PER_S * 1e3:.4g} ms, MUFU "
          f"{total.mufu / MUFU_PER_S * 1e3:.4g} ms), K5 {min(kern):.6g} "
          f"ms/step = {bound_ms / min(kern):.4g} of the bound")
    subkernels = []
    for key, fn in (("K5a", "column_p3_solve"), ("K5b", "column_p3_nodes"),
                    ("K5c", "column_p3_epilogue")):
        b = _ops_ms(ops[key])
        issued = warp_issued[key] / WARP_ISSUE_PER_S * 1e3
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
             "subkernels": subkernels})


def _k5_parts(K, model, state, guess, device):
    """ms of each of K5's kernels alone at GL-16 by CUDA events (best of
    5), with ``nvidia-smi`` sampling the SM clock and power beside them."""
    import torch

    from cloudmicrophysics_tpu_torch.models.column import _block_cols

    mp = model.mp
    ncol, nlev = state.rho.shape
    plan = K.launch_plan(ncol, nlev, 16, _block_cols(ncol))
    lib, params = K._library(), model.params
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                          device=device)
    loglam = torch.empty_like(state.rho)
    out = type(state)(*(torch.empty_like(t) for t in state))
    variant = K.K2M._variant(type(mp)(warm_rain=mp.warm_rain, ice=None))
    calls = {
        "K5a": lambda: K.launch_solve(lib, state, guess, loglam, scratch,
                                      params, plan, device),
        "K5b": lambda: K.launch_nodes(lib, state, scratch, params, 16, plan,
                                      device),
        "K5c": lambda: K.launch_epilogue(lib, state, out, scratch, params,
                                         plan, DT, DZ, variant, device),
    }
    for fn in calls.values():
        fn()
    times, clock = _with_sm_clock(
        lambda: {k: min(_time_ms(fn, reps=5)) for k, fn in calls.items()})
    print(f"  K5 kernels alone at GL-16: "
          + ", ".join(f"{k} {t:.6g} ms" for k, t in times.items())
          + f"; {clock}")
    return times


def _k5_ops(K, model, state, guess, device):
    """Operations K5a, K5b and K5c run on ``state`` at GL-16: the probe
    build's per-region executions times each region's operations on its
    least path through the timed build's SASS (kernels/opcount.py). Returns
    per kernel the :class:`opcount.Tally`, the instructions with every arm
    counted, and the warp instructions issued; writes the SASS and the
    probe's counts to ``kernels/build/``."""
    import gzip

    import torch

    from cloudmicrophysics_tpu_torch.kernels import _build, opcount
    from cloudmicrophysics_tpu_torch.models.column import _block_cols

    src = (_build.CSRC_DIR / K.SOURCE).read_text()
    names, sites = opcount.region_names(src), opcount.probe_sites(src)
    if set(names) != set(sites):
        raise AssertionError(f"regions without one K5_COUNT site: "
                             f"{sorted(set(names) ^ set(sites))}")
    plib = K._library("probe")
    if plib.column_p3_probe_regions() != len(names):
        raise AssertionError("probe build with another region list")
    mp = model.mp
    ncol, nlev = state.rho.shape
    plan = K.launch_plan(ncol, nlev, 16, _block_cols(ncol))
    params = model.params
    scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                          device=device)
    loglam = torch.empty_like(state.rho)
    out = type(state)(*(torch.empty_like(t) for t in state))
    variant = K.K2M._variant(type(mp)(warm_rain=mp.warm_rain, ice=None))
    counts, warps = {}, {}

    def probe(key, threads, fn):
        # rows: each region's thread executions, then its warp executions
        buf = torch.zeros((2 * len(names), threads), dtype=torch.int32,
                          device=device)
        err = plib.column_p3_probe_set(buf.data_ptr(), threads, device.index)
        if err:
            raise RuntimeError(f"column_p3_probe_set: CUDA error {err}")
        fn()
        sums = buf.sum(dim=1, dtype=torch.int64).tolist()
        counts[key] = dict(zip(names, sums[:len(names)]))
        warps[key] = dict(zip(names, sums[len(names):]))

    probe("K5a", plan.solve_grid * K.SOLVE_THREADS,
          lambda: K.launch_solve(plib, state, guess, loglam, scratch, params,
                                 plan, device))
    probe("K5b", plan.nodes_grid * K.NODE_THREADS,
          lambda: K.launch_nodes(plib, state, scratch, params, 16, plan,
                                 device))
    probe("K5c", plan.epilogue_grid * plan.epilogue_block,
          lambda: K.launch_epilogue(plib, state, out, scratch, params, plan,
                                    DT, DZ, variant, device))
    same = torch.equal(loglam, model(state, guess)[1])
    sass = opcount.disassemble(K.library_path())
    (_build.BUILD_DIR / "column_p3.sass.gz").write_bytes(
        gzip.compress(sass.encode()))
    (_build.BUILD_DIR / "column_p3_probe_counts.json").write_text(
        json.dumps({"threads": counts, "warps": warps}))
    limited, chen = variant
    instrs = [i for i in opcount.parse_sass(sass)
              if ("nodes_kernel" not in i.function or "ILi16E" in i.function)
              and ("epilogue_kernel" not in i.function
                   or f"ILb{limited}ELb{chen}E" in i.function)]
    per, static, copies, lost = opcount.region_tallies(instrs, sites,
                                                       K.SOURCE)
    print(f"  K5 operation count, GL-16: {len(instrs)} SASS instructions of "
          f"the timed build (the launched variants), {lost} of them in "
          f"slow-path subroutines or outside every counted region; probe "
          f"run's log lambda equal to the timed build's: {same}")
    print("    region: instructions per copy on the least path (with every "
          "arm) x copies, float32 operations and MUFU per copy, thread "
          "executions (unroll), instructions run, SIMT efficiency (thread "
          "executions / 32 x warp executions)")
    ops, every_arm, warp_issued = {}, {}, {}
    for key, c in counts.items():
        dyn = opcount.dynamic_count(per, c, sites)
        ops[key] = sum(dyn.values(), opcount.Tally())
        every_arm[key] = sum(static[n] * c[n] / sites[n].unroll
                             for n in names)
        warp_issued[key] = sum(t.issued for t in opcount.dynamic_count(
            per, warps[key], sites).values())
        for n in names:
            if c[n]:
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
          f"operations and {dup.mufu:.6g} MUFU, not counted as K5a's work")
    ops["K5a"] = ops["K5a"] + dup.scale(-1.0)
    return ops, every_arm, warp_issued


def _drive_p3(model, state, K, tag, rollouts=P3_ROLLOUTS):
    """A P3 path at full width: one cold step of ``model`` on ``state``,
    then ``rollouts`` timed rollouts of ``P3_STEPS`` steps, each starting
    from a rollout-distinct copy of ``state`` and the cold step's log
    lambda, carrying log lambda as the next step's guess. The launch
    counters (the step's and each of its three kernels') are set to 0 just
    before and read just after; checks that each equals the steps driven,
    that the results are finite and non-negative, and that q_rim <= q_ice.
    Returns the cold step, its log lambda, the launch counts and the
    ms/step of each rollout."""
    import torch

    counted = {"K5": K.step_column_p3_fused, "K5a": K.launch_solve,
               "K5b": K.launch_nodes, "K5c": K.launch_epilogue}
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
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
        for _ in range(P3_STEPS):
            s, ll = model(s, ll)
        end.record()
        end.synchronize()
        steps += P3_STEPS
        times.append(start.elapsed_time(end))
        checksums.append(float(s.q_ice.double().sum()))
        ends.append((s, ll))
    launches = {k: fn.launches for k, fn in counted.items()}
    torch.cuda.synchronize()
    if set(launches.values()) != {steps}:
        raise AssertionError(f"{tag}: launch counts {launches} != steps "
                             f"driven ({steps})")
    for name, (x, ll) in zip(["cold step"] + [f"rollout {r} end" for r in
                                             range(rollouts)],
                             [(first, first_ll)] + ends):
        for f, v in zip(x._fields, x):
            if tuple(v.shape) != (P3_NCOL, P3_NLEV) or not bool(
                    v.isfinite().all()):
                raise AssertionError(f"{tag} {name}: {f} not finite or "
                                     f"misshapen")
            if f.startswith(("q_", "n_", "b_")) and bool((v < 0).any()):
                raise AssertionError(f"{tag} {name}: {f} negative")
        if bool((x.q_rim > x.q_ice).any()):
            raise AssertionError(f"{tag} {name}: q_rim > q_ice")
        if bool(torch.isnan(ll).any()) or bool(torch.isposinf(ll).any()):
            raise AssertionError(f"{tag} {name}: log lambda NaN or +inf")
    ms = [t / P3_STEPS for t in times]
    pts = [P3_NCOL * P3_NLEV / (m * 1e-3) for m in ms]
    print(f"  {tag} ms/step: best {min(ms):.6g}, median "
          f"{float(np.median(ms)):.6g} (per rollout {[round(m, 6) for m in ms]})")
    print(f"  {tag} grid-points/s: best {max(pts):.6g}, median "
          f"{float(np.median(pts)):.6g}")
    print(f"  {tag} checksum sum(q_ice) per rollout: {checksums}")
    print(f"  {tag} launches in this path: {launches} (each = {steps} "
          f"steps: 1 cold + {rollouts} x {P3_STEPS})")
    return first, first_ll, launches, ms


if __name__ == "__main__":
    sys.exit(main())
