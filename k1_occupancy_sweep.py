"""Occupancy sweep of a fused column kernel on one NVIDIA GPU: the 1M
kernel (K1, the default) or the 2M warm-rain kernel (K3).

    python3 k1_occupancy_sweep.py [k1|k3]

``csrc/column1m.cu`` and ``csrc/column2m.cu`` hold their launch bounds in
two constants, ``kThreads`` (threads per block) and ``kMinBlocks``
(resident blocks per SM the compiler must leave registers for). For each
setting of :data:`SETTINGS` this script writes a copy of the source with
those two constants rewritten into ``kernels/build/sweep/`` and builds it
with the package's nvcc flags for the default parameter block (all builds
at once), then, on the packed (7, 524288, 128) float32 state of
``chip_smoke.py`` (the 1M or the 2M one), checks each build's step bit for
bit against the plain step and times it by CUDA events (best of 10). It
prints each setting's registers, spill bytes, resident blocks per SM and
ms/step, and names the fastest setting without spills: the one the source
should hold. Then it times the source's own build at each of
:data:`BLOCK_COLS` columns per block (the grid's last wave of blocks runs
part-empty).
"""

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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


def _kernel(name, device):
    """What the sweep needs of kernel ``name``: its module ``K``, the
    generated header and a ``bind`` of a build for the default parameter
    block, the source's own build, the packed full-size state and the plain
    step's result on it."""
    from chip_smoke import AFFINE, DT, DZ, NCOL, NLEV
    from cloudmicrophysics_tpu_torch.kernels import column1m, column2m
    from cloudmicrophysics_tpu_torch.models.bench_states import (
        device_state,
        device_state_2m,
    )
    from cloudmicrophysics_tpu_torch.parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        microphysics_2m_params,
        terminal_velocity_params,
    )

    tps = ThermodynamicsParameters()
    if name == "k1":
        K, mp = column1m, microphysics_1m_params()
        tv = terminal_velocity_params()
        params = K.kernel_params(mp, tps, tv)
        packed = K.pack_state(device_state(NCOL, NLEV, device))
        return SimpleNamespace(
            K=K, header=K.header(params), bind=K.bind,
            lib=K._library(params), packed=packed,
            ref=K.step_column_1m_packed_plain(packed, mp, tps, tv, DT, DZ,
                                              q_tot_affine=AFFINE))
    K, mp = column2m, microphysics_2m_params()
    params, variant = K.kernel_params_2m(mp, tps), K._variant(mp)
    packed = K.pack_state_2m(device_state_2m(NCOL, NLEV, device))
    return SimpleNamespace(
        K=K, header=K.header(params, variant),
        bind=lambda lib: K.bind(lib, variant),
        lib=K._library(params, variant), packed=packed,
        ref=K.step_column_2m_packed_plain(packed, mp, tps, DT, DZ,
                                          q_tot_affine=AFFINE))


def _build_variant(K, header, _build, opcount, threads, blocks):
    """Build one setting; returns (library path, ptxas report with the
    kernel's SASS instruction count under ``sass``)."""
    stem = K.SOURCE.removesuffix(".cu")
    out = _build.BUILD_DIR / "sweep" / f"{stem}_t{threads}_b{blocks}"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{stem}_params.h").write_text(header)
    src = out / K.SOURCE
    src.write_text(_variant((_build.CSRC_DIR / K.SOURCE).read_text(),
                            threads, blocks))
    lib = out / f"lib{stem}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *K.BUILDS["kernel"],
           "-I", str(out), "-I", str(_build.CSRC_DIR), "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stderr}")
    report = _build.ptxas_report(proc.stdout + proc.stderr)
    kernel = f"{stem}_step_kernel"
    ptx = next(v for f, v in report.items() if kernel in f and "stack" in v)
    sass = opcount.parse_sass(opcount.disassemble(lib))
    ptx["sass"] = sum(1 for i in sass if kernel in i.function)
    return lib, ptx


def main(argv):
    import ctypes

    import torch

    name = argv[0] if argv else "k1"
    if name not in ("k1", "k3"):
        print(f"k1_occupancy_sweep: unknown kernel {name!r} (k1 or k3)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_occupancy_sweep: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2

    from chip_smoke import AFFINE, DT, DZ, NCOL, NLEV, _gpu_line, _time_ms
    from cloudmicrophysics_tpu_torch.kernels import _build, opcount

    print(f"gpu: {_gpu_line()}")
    device = torch.device("cuda", 0)
    kern = _kernel(name, device)
    K = kern.K
    stem = K.SOURCE.removesuffix(".cu")
    with ThreadPoolExecutor(len(SETTINGS)) as pool:
        built = list(pool.map(
            lambda s: _build_variant(K, kern.header, _build, opcount, *s),
            SETTINGS))
    bc = _build.fit_block_cols(NCOL, K.BLOCK_COLS)

    def best_ms(lib, block_cols):
        def run():
            return K.launch_packed(lib, kern.packed, DT, DZ, block_cols,
                                   q_tot_affine=AFFINE)

        same = torch.equal(run(), kern.ref)
        return min(_time_ms(run, reps=10)), same

    rows = []
    print(f"{name.upper()} at ({NCOL}, {NLEV}) float32, block_cols {bc}: "
          f"threads, min blocks, registers, spill stores/loads B, resident "
          f"blocks per SM, the kernel's SASS instructions, ms/step (best of "
          f"10), bit-identical to the plain step")
    for (threads, blocks), (path, ptx) in zip(SETTINGS, built):
        lib = kern.bind(ctypes.CDLL(str(path)))
        attrs = _build.kernel_attrs(lib, stem, device.index)
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
    scan = {b: best_ms(kern.lib, b) for b in BLOCK_COLS}
    attrs = _build.kernel_attrs(kern.lib, stem, device.index)
    print(f"the source's build ({attrs}) at block_cols "
          + ", ".join(f"{b}: {ms:.6g} ms/step" for b, (ms, _) in scan.items()))
    if not all(same for _, same in scan.values()):
        raise AssertionError("a block_cols setting differs from the plain "
                             "step")
    print(_gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
