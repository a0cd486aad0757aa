"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused 1M column kernel from ``cloudmicrophysics_tpu_torch/
kernels/csrc`` with ``nvcc`` (into the package's ignored ``build/``
directory), then, failing at the first phase that does not hold:

1. prints the toolchain (GPU name and power limit, torch, CUDA, nvcc,
   whether triton imports);
2. prints the build time and the compiler's register/spill report;
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
   share over 10 fused steps with ``torch.profiler``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits with a non-zero code and prints no result.
"""

import json
import subprocess
import sys
import time

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from cloudmicrophysics_tpu_torch.kernels import column1m as K
    from cloudmicrophysics_tpu_torch.models.column import Column1MStep
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
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
    t0 = time.perf_counter()
    K._library()
    print(f"column1m.cu built and loaded in {time.perf_counter() - t0:.1f} s")
    for log in _build.BUILD_DIR.glob("column1m-*/build.log"):
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
    torch.cuda.synchronize()
    fused.launches = packed_fused.launches = 0
    first = model(state)                      # one step on the unpacked state
    packed = K.pack_state(state)
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
    launches = {"K1": packed_fused.launches, "K2": fused.launches}
    torch.cuda.synchronize()
    if launches != {"K1": steps_packed, "K2": 1}:
        raise AssertionError(f"launch counts {launches} != steps driven "
                             f"(K1 {steps_packed}, K2 1)")
    if not all(np.isfinite(checksums)):
        raise AssertionError(f"non-finite checksum {checksums}")
    for name, x in zip(("first step", "rollout end"),
                       (first, K.unpack_state(s))):
        for f, v in zip(x._fields, x):
            if tuple(v.shape) != (NCOL, NLEV) or not bool(v.isfinite().all()):
                raise AssertionError(f"{name}: {f} not finite or misshapen")
            if f.startswith("q_") and bool((v < 0).any()):
                raise AssertionError(f"{name}: {f} negative")
    ms = [t / N_STEPS for t in times]
    pts = [NCOL * NLEV / (m * 1e-3) for m in ms]
    print(f"ms/step: best {min(ms):.6g}, median {float(np.median(ms)):.6g} "
          f"(per rollout {[round(m, 6) for m in ms]})")
    print(f"grid-points/s: best {max(pts):.6g}, median "
          f"{float(np.median(pts)):.6g}")
    print(f"checksum sum(q_rai) per rollout: {checksums}")
    print(f"launches in the main path: K1 {launches['K1']} "
          f"(= {steps_packed} packed steps), K2 {launches['K2']} "
          f"(= 1 unpacked step)")
    max_err["K2"] = max(max_err["K2"], _report(
        "K2 main path's full-size step vs plain",
        _compare(first, K.step_column_1m_plain(state, mp, tps, tv, DT, DZ))))
    del first, s

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
    del buf

    src = "cloudmicrophysics_tpu_torch/kernels/csrc/column1m.cu"
    kernels = [
        {"name": "column1m_step_packed (K1)", "route": "cuda", "source": src,
         "replaces": "cloudmicrophysics_tpu/kernels/column1m.py:149",
         "launches": launches["K1"], "max_abs_err": max_err["K1"],
         "ms": timing["K1"][0], "plain_ms": timing["K1"][1]},
        {"name": "column1m_step_unpacked (K2)", "route": "cuda", "source": src,
         "replaces": "cloudmicrophysics_tpu/kernels/column1m.py:80",
         "launches": launches["K2"], "max_abs_err": max_err["K2"],
         "ms": timing["K2"][0], "plain_ms": timing["K2"][1]},
    ]
    print(_gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
