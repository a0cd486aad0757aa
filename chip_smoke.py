"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused 1M, 2M and 2M + P3 column kernels from
``cloudmicrophysics_tpu_torch/kernels/csrc`` with ``nvcc`` (one compiler per
source, started together, into the package's ignored ``build/`` directory),
then, failing at the first phase that does not hold:

1. prints the toolchain (GPU name and power limit, torch, CUDA, nvcc,
   whether triton imports);
2. prints each source's build time and the compiler's register/spill
   report;
3. compares both kernel entry points (packed and unpacked) with their plain
   PyTorch versions on the card at three cases, (4096, 128), a ragged
   (1000, 40) and the in-kernel ``q_tot`` affine, under rtol 2e-5 /
   atol 2e-9, and checks that two ``block_cols`` tilings agree bit for bit;
4. drives the main path at full width: ``Column1MStep`` over the packed
   (7, 524288, 128) float32 state of the repo's benchmark recipe, one step
   on the unpacked state and then three timed 30-step rollouts with the
   benchmark's ``q_tot`` affine schedule, checking that the result is
   finite and non-negative and that the kernels' launch counters went up
   by exactly the steps driven, and holding the one unpacked step against
   the plain version;
5. times each kernel and its plain version at that size by CUDA events and
   compares one full-size packed step with the plain version;
6. times a plain streaming pass over the packed state (``torch.mul``, the
   memory roof the kernel is quoted against) and measures the device's idle
   share over 10 fused steps with ``torch.profiler``;
7. compares both 2M warm-rain kernel entry points (packed, K3, and
   unpacked, K4) with their plain versions at (4096, 128), a ragged
   (1000, 40), the in-kernel ``q_tot`` affine, ``is_limited=False``,
   ``rain_velocity="chen2022"`` and the benchmark's uniform 2M state, under
   the same tolerance, with two tilings agreeing bit for bit;
8. drives the 2M path at full width: ``Column2MStep`` over a packed
   (7, 524288, 128) float32 2M state, one step on the unpacked state and
   three timed 30-step rollouts with the same ``q_tot`` affine schedule,
   with the same checks, holding the unpacked step against the plain
   version;
9. times K3 and K4 and their plain versions at that size, holds one
   full-size packed step against the plain version, quotes K3 against
   the streaming pass of phase 6, counts the plain step's device kernels
   and measures the device's idle share over 10 K3 steps;
10. compares the 2M + P3 kernel (K5) with its plain version at quadrature
    orders 4, 8 and 16 on the 10 curated ladder states tiled over
    (640, 16), a seeded mixed-regime (4096, 64) state and a ragged
    (1000, 40) one, each cold and warm-started from the plain step's log
    lambda, under log lambda rtol 2e-5 and fields rtol 3e-5 / atol 1e-10
    (the Pallas P3 kernel's contract), with two tilings agreeing bit for
    bit, also with ``is_limited=False`` and Chen 2022 rain; then prints the
    kernel's float32 per-field error against the JAX package's float64 step
    on the ladder states (the record in the package's ``data/``);
11. drives the P3 path at full width: ``ColumnP3Step`` on a (16384, 128)
    float32 state (the TPU benchmark's P3 state with rho and T profiles and
    seeded jitter) at GL-16, one cold step and three 10-step rollouts
    carrying log lambda as the next step's guess, checking finiteness,
    non-negativity, ``q_rim <= q_ice`` and the launch counter, holding the
    cold step against the plain version, then one 10-step rollout at GL-8;
12. times K5 and the plain step (run in 16 column chunks) at that size,
    measures the device's idle share over 10 K5 steps, prints the plain
    step's peak device memory and device kernels (counted on one column
    chunk) and quotes K5 against the streaming pass of phase 6.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits with a non-zero code and prints no result.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NCOL, NLEV = 524288, 128      # the size the repo's benchmark has always run
DT, DZ = 1.0, 100.0
N_STEPS, N_ROLLOUTS = 30, 3   # the benchmark's rollout length and count
RTOL, ATOL = 2e-5, 2e-9       # the Pallas kernel's contract (tests/test_kernels.py)
AFFINE = (1.0 + 1e-4 * 5, 1e-9 * 6)


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

    with ThreadPoolExecutor(3) as pool:
        builds = dict(zip(("column1m", "column2m", "column_p3"), pool.map(
            timed_build, (K._library, K2M._library, K5._library))))
    for stem, seconds in builds.items():
        print(f"{stem}.cu built and loaded in {seconds:.1f} s")
        for log in _build.BUILD_DIR.glob(f"{stem}-*/build.log"):
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel parity on the card --------------------------------------
    print(f"== kernel vs plain version (rtol {RTOL}, atol {ATOL})")
    params = K.kernel_params(mp, tps, tv, device=device)
    max_err = {"K1": 0.0, "K2": 0.0}
    cases = [("(4096, 128)", 4096, 128, (256, 128), None),
             ("ragged (1000, 40)", 1000, 40, (8, 40), None),
             ("affine (4096, 128)", 4096, 128, (256, 64), AFFINE)]
    for label, ncol, nlev, tilings, affine in cases:
        st = _device_state(ncol, nlev, device, seed=7)
        kw = dict(q_tot_affine=affine)
        ref = K.step_column_1m_plain(st, mp, tps, tv, DT, DZ, **kw)
        outs = [fused(st, mp, tps, tv, DT, DZ, block_cols=bc, params=params,
                      **kw) for bc in tilings]
        max_err["K2"] = max(max_err["K2"],
                            _report(f"K2 {label} block_cols={tilings[0]}",
                                    _compare(outs[0], ref)))
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
        if not torch.equal(pouts[0], pouts[1]):
            raise AssertionError(f"K1 {label}: block_cols {tilings} differ")
        print(f"  K1 {label}: block_cols {tilings} agree bit for bit")
    st = _device_state(4096, 128, device, seed=7)
    max_err["K2"] = max(max_err["K2"], _report(
        "K2 (4096, 128) sediment_cloud=False",
        _compare(fused(st, mp, tps, tv, DT, DZ, sediment_cloud=False,
                       params=params),
                 K.step_column_1m_plain(st, mp, tps, tv, DT, DZ,
                                        sediment_cloud=False))))
    del st, pk, ref, pref, outs, pouts

    # ---- 4. the main path at full width ------------------------------------
    print(f"== main path: Column1MStep on ({NCOL}, {NLEV}) float32, "
          f"{N_ROLLOUTS} x {N_STEPS} steps")
    state = _device_state(NCOL, NLEV, device)
    model = Column1MStep(mp, tps, tv, DT, DZ).to(device)
    first, packed, launches = _drive(model, state, K.pack_state,
                                     K.unpack_state, fused, packed_fused,
                                     ("K1", "K2"))
    max_err["K2"] = max(max_err["K2"], _report(
        "K2 main path's full-size step vs plain",
        _compare(first, K.step_column_1m_plain(state, mp, tps, tv, DT, DZ))))
    del first

    # ---- 5. kernels and plain versions at full size ------------------------
    print(f"== kernel vs plain version at ({NCOL}, {NLEV}), CUDA events")
    torch.cuda.reset_peak_memory_stats(device)
    plain2 = _time_ms(lambda: K.step_column_1m_plain(
        state, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE), reps=3)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    kern2 = _time_ms(lambda: fused(state, mp, tps, tv, DT, DZ,
                                   params=model.params,
                                   q_tot_affine=AFFINE), reps=10)
    kern1 = _time_ms(lambda: model(packed, q_tot_affine=AFFINE), reps=10)
    plain1 = _time_ms(lambda: K.step_column_1m_packed_plain(
        packed, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE), reps=3)
    timing = {"K1": (min(kern1), min(plain1)), "K2": (min(kern2), min(plain2))}
    for k, (t_kern, t_plain) in timing.items():
        print(f"  {k}: kernel {t_kern:.6g} ms/step, plain {t_plain:.6g} "
              f"ms/step, plain/kernel {t_plain / t_kern:.4g}")
    print(f"  plain version peak device memory {peak_gb:.4g} GB")
    full = _report("K1 one full-size step vs plain", _compare(
        K.unpack_state(model(packed, q_tot_affine=AFFINE)),
        K.unpack_state(K.step_column_1m_packed_plain(
            packed, mp, tps, tv, DT, DZ, q_tot_affine=AFFINE))))
    max_err["K1"] = max(max_err["K1"], full)

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

    launches5, max_err5, timing5 = _run_p3(
        device, K5, ColumnP3Step, microphysics_2m_params, tps,
        nbytes / copy_ms / 1e6)
    launches.update(launches5)
    max_err.update(max_err5)
    timing.update(timing5)

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
         "ms": timing[k][0], "plain_ms": timing[k][1]}
        for k, fn, src, tpu in entries]
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
    cases = [
        ("(4096, 128)", {}, 4096, 128, (256, 128), None, False),
        ("ragged (1000, 40)", {}, 1000, 40, (8, 40), None, False),
        ("affine (4096, 128)", {}, 4096, 128, (128, 64), AFFINE, False),
        ("is_limited=False", {"is_limited": False}, 4096, 128, (256, 64),
         None, False),
        ("rain_velocity=chen2022", {"rain_velocity": "chen2022"}, 4096, 128,
         (256, 64), None, False),
        ("uniform bench state", {}, 4096, 128, (256, 128), None, True),
    ]
    for label, opts, ncol, nlev, tilings, affine, uniform in cases:
        mpc = microphysics_2m_params(**opts)
        params = K.kernel_params_2m(mpc, tps, device=device)
        st = _device_state_2m(ncol, nlev, device, seed=7, uniform=uniform)
        if affine is None:   # K4 has no affine, as the Pallas kernel
            ref = K.step_column_2m_plain(st, mpc, tps, DT, DZ)
            outs = [fused(st, mpc, tps, DT, DZ, block_cols=bc, params=params)
                    for bc in tilings]
            max_err["K4"] = max(max_err["K4"], _report(
                f"K4 {label} block_cols={tilings[0]}", _compare(outs[0], ref)))
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
        if not torch.equal(pouts[0], pouts[1]):
            raise AssertionError(f"K3 {label}: block_cols {tilings} differ")
        print(f"  K3 {label}: block_cols {tilings} agree bit for bit")
    del st, pk, pref, pouts

    # ---- 8. the 2M path at full width --------------------------------------
    print(f"== 2M path: Column2MStep on ({NCOL}, {NLEV}) float32, "
          f"{N_ROLLOUTS} x {N_STEPS} steps")
    state = _device_state_2m(NCOL, NLEV, device)
    model = Column2MStep(mp, tps, DT, DZ).to(device)
    first, packed, launches = _drive(model, state, K.pack_state_2m,
                                     K.unpack_state_2m, fused, packed_fused,
                                     ("K3", "K4"))
    max_err["K4"] = max(max_err["K4"], _report(
        "K4 2M path's full-size step vs plain",
        _compare(first, K.step_column_2m_plain(state, mp, tps, DT, DZ))))
    del first

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
    max_err["K3"] = max(max_err["K3"], _report(
        "K3 one full-size step vs plain", _compare(
            K.unpack_state_2m(model(packed, q_tot_affine=AFFINE)),
            K.unpack_state_2m(K.step_column_2m_packed_plain(
                packed, mp, tps, DT, DZ, q_tot_affine=AFFINE)))))
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


def _run_p3(device, K, ColumnP3Step, microphysics_2m_params, tps, copy_gbs):
    """Phases 10-12: the 2M + P3 kernel K5 against its plain version, the P3
    path at full width, and the timings. Returns the launch counts of the
    main path, the largest error and the (kernel, plain) times."""
    import json
    from pathlib import Path

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
                                              device), (128, 64)),
        ("mixed (4096, 64)", _p3_mixed_state(4096, 64, device, seed=3),
         (128, 256)),
        ("ragged (1000, 40)", _p3_mixed_state(1000, 40, device, seed=5),
         (8, 40)),
    ]
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
                if not (all(torch.equal(x, y) for x, y in zip(a, b))
                        and torch.equal(la, lb)):
                    raise AssertionError(f"K5 {tag} {label} {start}: "
                                         f"block_cols {tilings} differ")
        print(f"  K5 {tag}: every case's tilings agree bit for bit")
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
    model = ColumnP3Step(mp16, tps, DT, DZ).to(device)
    first, first_ll, launches, ms = _drive_p3(model, state, fused, "GL-16")
    ref, ref_ll = K.step_column_p3_plain(state, mp16, tps, DT, DZ,
                                         col_chunks=P3_CHUNKS)
    max_err = max(max_err, _compare_p3("K5 P3 path's full-size cold step "
                                       "vs plain", first, first_ll, ref,
                                       ref_ll))
    del ref, ref_ll
    mp8 = microphysics_2m_params(with_ice=True, quadrature_order=8)
    model8 = ColumnP3Step(mp8, tps, DT, DZ).to(device)
    _drive_p3(model8, state, fused, "GL-8", rollouts=1)

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
    return {"K5": launches}, {"K5": max_err}, timing


def _drive_p3(model, state, fused, tag, rollouts=P3_ROLLOUTS):
    """A P3 path at full width: one cold step of ``model`` on ``state``,
    then ``rollouts`` timed rollouts of ``P3_STEPS`` steps, each starting
    from a rollout-distinct copy of ``state`` and the cold step's log
    lambda, carrying log lambda as the next step's guess. The launch counter
    is set to 0 just before and read just after; checks that it equals the
    steps driven, that the results are finite and non-negative, and that
    q_rim <= q_ice. Returns the cold step, its log lambda, the launch count
    and the ms/step of each rollout."""
    import torch

    torch.cuda.synchronize()
    fused.launches = 0
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
    launches = fused.launches
    torch.cuda.synchronize()
    if launches != steps:
        raise AssertionError(f"{tag}: launch count {launches} != steps "
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
    print(f"  {tag} launches in this path: {launches} (= {steps} steps: 1 "
          f"cold + {rollouts} x {P3_STEPS})")
    return first, first_ll, launches, ms


if __name__ == "__main__":
    sys.exit(main())
