"""Build and load the CUDA kernels of this package.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Nothing is built when this module is imported: the build
happens at the first launch, into ``build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source, the shared headers of
``csrc/`` (``*.cuh``), the generated header and the flags (a source may add
its own), so an edited source is rebuilt and an unchanged one is reused.

What building and loading cost is counted in :mod:`..trace`:
``kernels.builds`` and ``kernels.build_s`` (``nvcc`` runs, the span
``kernels.build``), ``kernels.loads`` (libraries loaded) and
``kernels.load_s`` (a library's ``dlopen``, binding and checks, the span
``kernels.load`` (:func:`loading`), and its first launch, where CUDA loads
the library's module (:func:`launching`)).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import trace

KERNELS_DIR = Path(__file__).resolve().parent
CSRC_DIR = KERNELS_DIR / "csrc"
BUILD_DIR = KERNELS_DIR / "build"

# Parity with the eager PyTorch step comes first: no fast math, and no
# contraction of a*b+c into one FMA, so the kernel rounds operation by
# operation as the eager code does. A float64 column build replaces
# --fmad=false by --fmad=true (dtype_flags; csrc/real.cuh says why): its own
# arithmetic is uncontracted by construction there.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The ``nvcc`` of the CUDA toolkit: ``$CUDA_HOME``, then PyTorch's
    idea of it, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def index_header(names, guard: str, defines=()) -> str:
    """A C header with ``#define P_<name> <index>`` for each name,
    ``defines`` (pairs of a macro name and its value) and ``N_PARAMS``: the
    device-side view of a parameter buffer's order."""
    lines = [f"// Generated from the parameter list of the kernel's Python "
             f"module; do not edit.",
             f"#ifndef {guard}", f"#define {guard}"]
    lines += [f"#define P_{name} {i}" for i, name in enumerate(names)]
    lines += [f"#define {name} {value}" for name, value in defines]
    lines += [f"#define N_PARAMS {len(names)}", "#endif", ""]
    return "\n".join(lines)


# the scalar types a column kernel is built for: the C type of each, and the
# suffix of its hexadecimal literals
_C_TYPES = {torch.float32: ("float", "f"), torch.float64: ("double", "")}


def check_dtype(dtype: torch.dtype, kernel: str) -> None:
    """Raise ``NotImplementedError`` unless a column kernel can be built for
    ``dtype`` (float32 or float64). ``kernel`` names it in the message."""
    if dtype not in _C_TYPES:
        raise NotImplementedError(
            f"the CUDA {kernel} column kernel supports float32 and float64, "
            f"not {dtype}")


def dtype_flags(dtype: torch.dtype) -> tuple:
    """The nvcc flags a column kernel's build for ``dtype`` adds:
    ``--fmad=true`` for float64 (its cells compute on csrc/real.cuh's
    uncontracted Dbl, and the CUDA math library's double pow rounds as in
    PyTorch's kernels only with contraction on), none for float32."""
    return ("--fmad=true",) if dtype == torch.float64 else ()


def c_type(dtype: torch.dtype) -> str:
    """The C scalar type of a build for ``dtype``: ``float`` or ``double``."""
    return _C_TYPES[dtype][0]


def c_scalar(dtype: torch.dtype):
    """The ``ctypes`` type of a scalar argument of a build for ``dtype``."""
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def literal_header(module: str, names, block: torch.Tensor,
                   defines=()) -> str:
    """The generated header of a kernel built for one parameter block:
    ``#define PC_<name>`` as a hexadecimal literal of each value of
    ``block`` (exact) in the block's dtype (``0x1.8p+1f`` for float32,
    ``0x1.8p+1`` for float64), in the order of ``names``, then ``defines``
    (pairs of a macro name and its value) and ``N_PARAMS``. ``module``: the
    kernel's Python module (``kernels/<module>.py``), which names the
    guard."""
    if block.dtype not in _C_TYPES:
        raise ValueError(f"a parameter block is float32 or float64, not "
                         f"{block.dtype}")
    suffix = _C_TYPES[block.dtype][1]
    values = block.numpy()
    if values.shape != (len(names),):
        raise ValueError(f"a parameter block has {len(names)} values")
    if not np.isfinite(values).all():
        raise ValueError("the parameter block holds a non-finite value")
    guard = f"{module.upper()}_PARAMS_H"
    lines = [f"// Generated from kernels/{module}.py's parameter block; "
             "do not edit.", f"#ifndef {guard}", f"#define {guard}"]
    lines += [f"#define PC_{name} ({float(v).hex()}{suffix})"
              for name, v in zip(names, values)]
    lines += [f"#define {name} {value}" for name, value in defines]
    lines += [f"#define N_PARAMS {len(names)}", "#endif", ""]
    return "\n".join(lines)


def host_block(params: torch.Tensor, n: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``params`` itself when it is a parameter block a kernel can be built
    for: a contiguous ``(n,)`` tensor of ``dtype`` (the state's) on the
    host. Never copies from a device: a block anywhere but on the CPU, or
    of another dtype or shape, raises ``ValueError``."""
    if (params.device.type != "cpu" or params.dtype != dtype
            or params.shape != (n,) or not params.is_contiguous()):
        raise ValueError(
            f"params must be the host parameter block: a contiguous {dtype} "
            f"({n},) CPU tensor, not {params.dtype} {tuple(params.shape)} on "
            f"{params.device}")
    return params


def kernel_attrs(lib: ctypes.CDLL, prefix: str, device: int = 0) -> dict:
    """Registers and local memory bytes per thread, threads per block and
    resident blocks per SM of the kernel of a loaded library whose C entry
    points ``<prefix>_kernel_attrs``, ``<prefix>_blocks_per_sm`` and
    ``<prefix>_threads_per_block`` report them (from the CUDA runtime)."""
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = (getattr(lib, f"{prefix}_kernel_attrs")(ctypes.byref(regs),
                                                  ctypes.byref(local))
           or getattr(lib, f"{prefix}_blocks_per_sm")(device,
                                                      ctypes.byref(blocks)))
    if err:
        raise RuntimeError(f"{prefix} kernel attributes: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value,
            "threads": getattr(lib, f"{prefix}_threads_per_block")(),
            "blocks_per_sm": blocks.value}


# this thread's nvcc seconds, which loading() leaves out of a load's time
_THREAD = threading.local()
# libraries loaded whose first launch has not run yet
_UNLAUNCHED = set()


def build(source: str, header_name: str, header_text: str,
          flags: tuple = ()) -> Path:
    """Compile ``csrc/<source>`` (with the generated header and the extra
    nvcc ``flags``) and return the path of the shared library; reuse it
    when it already exists."""
    src = CSRC_DIR / source
    shared = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    base = NVCC_FLAGS
    if any(f.startswith("--fmad") for f in flags):   # the build's own choice
        base = tuple(f for f in base if not f.startswith("--fmad"))
    nvcc_flags = base + tuple(flags)
    key = hashlib.sha256(
        src.read_bytes() + shared + header_text.encode()
        + " ".join(nvcc_flags).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{src.stem}-{key}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / header_name).write_text(header_text)
    tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *nvcc_flags, "-I", str(out_dir), "-o", str(tmp),
           str(src)]
    t0 = time.perf_counter()
    with trace.span("kernels.build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    trace.count("kernels.builds")
    trace.add_seconds("kernels.build_s", seconds)
    _THREAD.build_s = getattr(_THREAD, "build_s", 0.0) + seconds
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n"
            + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: str, header_name: str, header_text: str,
         flags: tuple = ()) -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    lib = ctypes.CDLL(str(build(source, header_name, header_text, flags)))
    trace.count("kernels.loads")
    _UNLAUNCHED.add(lib)
    return lib


def loads() -> int:
    """Libraries this process has loaded (each built first if needed): the
    counter ``kernels.loads``. A call that raises it built or loaded a
    kernel library."""
    return trace.counter("kernels.loads")


@contextlib.contextmanager
def loading():
    """A kernel module's whole look-up of a library it has not held yet:
    the span ``kernels.load``, whose seconds, less those of an ``nvcc``
    build inside it, are added to ``kernels.load_s``."""
    built = getattr(_THREAD, "build_s", 0.0)
    t0 = time.perf_counter()
    with trace.span("kernels.load"):
        yield
    trace.add_seconds("kernels.load_s", time.perf_counter() - t0
                      - (getattr(_THREAD, "build_s", 0.0) - built))


def launching(lib: ctypes.CDLL):
    """A context for the launches of one step through ``lib``: the first
    time, where CUDA loads the library's module, its seconds are added to
    ``kernels.load_s``; a null context after that."""
    if lib not in _UNLAUNCHED:
        return contextlib.nullcontext()
    _UNLAUNCHED.discard(lib)
    return trace.timed("kernels.load_s")


def ptxas_report(log: str) -> dict:
    """Function -> ``registers`` (kernels only), ``stack`` (bytes of stack
    frame), ``spill_stores`` and ``spill_loads`` (bytes) from the
    ``-Xptxas -v`` lines of a build log."""
    report, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            report.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            report.setdefault(entry, {})["registers"] = int(m.group(1))
            entry = None
    return report
