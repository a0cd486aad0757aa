"""Occupancy sweep of the fused 1M column kernel (K1) on one NVIDIA GPU.

    python3 k1_occupancy_sweep.py

``csrc/column1m.cu`` holds its launch bounds in two constants, ``kThreads``
(threads per block) and ``kMinBlocks`` (resident blocks per SM the compiler
must leave registers for). For each setting of :data:`SETTINGS` this script
writes a copy of the source with those two constants rewritten into
``kernels/build/sweep/`` and builds it with the package's nvcc flags (all
builds at once), then, on the packed (7, 524288, 128) float32 state of
``chip_smoke.py``, checks each build's step bit for bit against the plain
step and times it by CUDA events (best of 10). It prints each setting's
registers, spill bytes, resident blocks per SM and ms/step, and names the
fastest setting without spills: the one the source should hold. Then it
times the source's own build at each of :data:`BLOCK_COLS` columns per
block (the grid's last wave of blocks runs part-empty).
"""

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# (threads per block, minimum resident blocks per SM): register caps from
# 255 down to 64 per thread
SETTINGS = ((256, 1), (256, 2), (256, 3), (256, 4), (128, 5), (128, 6),
            (128, 8), (512, 1), (512, 2))
BLOCK_COLS = (16, 32, 64, 128, 256)


def _variant(src, threads, blocks):
    out, n = re.subn(r"constexpr int kThreads = \d+;",
                     f"constexpr int kThreads = {threads};", src)
    out, m = re.subn(r"constexpr int kMinBlocks = \d+;",
                     f"constexpr int kMinBlocks = {blocks};", out)
    if (n, m) != (1, 1):
        raise RuntimeError("kThreads or kMinBlocks not found once in the "
                           "source")
    return out


def _build_variant(K, _build, opcount, params, threads, blocks):
    """Build one setting; returns (library path, ptxas report with the
    kernel's SASS instruction count under ``sass``)."""
    out = _build.BUILD_DIR / "sweep" / f"t{threads}_b{blocks}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "column1m_params.h").write_text(K.header(params))
    src = out / "column1m.cu"
    src.write_text(_variant((_build.CSRC_DIR / K.SOURCE).read_text(),
                            threads, blocks))
    lib = out / "libcolumn1m.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *K.BUILDS["kernel"],
           "-I", str(out), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stderr}")
    report = _build.ptxas_report(proc.stdout + proc.stderr)
    ptx = next(v for f, v in report.items()
               if "column1m_step_kernel" in f and "stack" in v)
    sass = opcount.parse_sass(opcount.disassemble(lib))
    ptx["sass"] = sum(1 for i in sass if "column1m_step_kernel" in i.function)
    return lib, ptx


def main():
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("k1_occupancy_sweep: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2

    from chip_smoke import AFFINE, DT, DZ, NCOL, NLEV, _device_state, _gpu_line
    from cloudmicrophysics_tpu_torch.kernels import _build, opcount
    from cloudmicrophysics_tpu_torch.kernels import column1m as K
    from cloudmicrophysics_tpu_torch.models.column import _block_cols
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        terminal_velocity_params,
    )

    print(f"gpu: {_gpu_line()}")
    mp, tps = microphysics_1m_params(), ThermodynamicsParameters()
    tv = terminal_velocity_params()
    params = K.kernel_params(mp, tps, tv)
    with ThreadPoolExecutor(len(SETTINGS)) as pool:
        built = list(pool.map(
            lambda s: _build_variant(K, _build, opcount, params, *s),
            SETTINGS))
    device = torch.device("cuda", 0)
    packed = K.pack_state(_device_state(NCOL, NLEV, device))
    ref = K.step_column_1m_packed_plain(packed, mp, tps, tv, DT, DZ,
                                        q_tot_affine=AFFINE)
    bc = _block_cols(NCOL, K.BLOCK_COLS)

    def best_ms(lib, block_cols):
        def run():
            return K.launch_packed(lib, packed, DT, DZ, block_cols,
                                   q_tot_affine=AFFINE)

        same = torch.equal(run(), ref)
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times), same

    rows = []
    print(f"K1 at ({NCOL}, {NLEV}) float32, block_cols {bc}: threads, "
          f"min blocks, registers, spill stores/loads B, resident blocks "
          f"per SM, the kernel's SASS instructions, ms/step (best of 10), "
          f"bit-identical to the plain step")
    for (threads, blocks), (path, ptx) in zip(SETTINGS, built):
        lib = K.bind(ctypes.CDLL(str(path)))
        attrs = K.kernel_attrs(lib, device.index)
        ms, same = best_ms(lib, bc)
        spills = ptx["spill_stores"] + ptx["spill_loads"]
        rows.append((ms, spills, threads, blocks))
        print(f"  {threads} {blocks}: {attrs['registers']} registers, "
              f"{ptx['spill_stores']}/{ptx['spill_loads']} B spills, "
              f"{attrs['blocks_per_sm']} blocks per SM, {ptx['sass']} SASS "
              f"instructions, {ms:.6g} "
              f"ms/step, {'bit-identical' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"setting {threads}x{blocks} differs from "
                                 f"the plain step")
    best = min(r for r in rows if r[1] == 0)
    print(f"fastest without spills: kThreads {best[2]}, kMinBlocks {best[3]} "
          f"({best[0]:.6g} ms/step)")
    lib = K._library(params)
    scan = {b: best_ms(lib, b) for b in BLOCK_COLS}
    print(f"the source's build ({K.kernel_attrs(lib, device.index)}) at "
          f"block_cols " + ", ".join(f"{b}: {ms:.6g} ms/step"
                                     for b, (ms, _) in scan.items()))
    if not all(same for _, same in scan.values()):
        raise AssertionError("a block_cols setting differs from the plain "
                             "step")
    print(_gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
