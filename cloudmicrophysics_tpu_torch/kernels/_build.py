"""The host side of this package's CUDA kernels: their build, their
libraries, their launch checks and their launches.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Nothing is built when this module is imported: the build
happens at the first launch, into ``build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source, the shared headers of
``csrc/`` (``*.cuh``), the generated header and the flags (a source may add
its own), so an edited source is rebuilt and an unchanged one is reused.

The kernel modules keep only what is their own (their parameters, their
generated header, their C signatures and build checks, their launch
arguments) and share the rest through this module:

* :func:`library`, the one cache of loaded libraries, looked up by
  :func:`library_key`: a library is built, loaded, bound and checked once;
* :func:`launch`, the launch tail: the span ``launch.<kernel>``, the call,
  a ``RuntimeError`` on a CUDA error and the counter ``launches.<wrapper>``;
* the launch checks (:func:`check_cuda`, :func:`check_tiling`,
  :func:`check_fields`, :func:`check_packed`, :func:`check_dtype`,
  :func:`host_block`) and the columns a thread block steps
  (:func:`fit_block_cols`).

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
from ..parallel.comms import is_dtensor

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


def load(path) -> ctypes.CDLL:
    """Load the built library at ``path``: a new ``CDLL`` at each call,
    counted in ``kernels.loads``, whose first launch :func:`launching`
    times. The kernel modules hold theirs through :func:`library`."""
    lib = ctypes.CDLL(str(path))
    trace.count("kernels.loads")
    _UNLAUNCHED.add(lib)
    return lib


# the loaded libraries, by library_key
_LIBRARIES = {}


def library_key(source: str, build: str, variant,
                block: torch.Tensor | None = None) -> tuple:
    """What tells two libraries apart: the source, its build (``"kernel"``,
    ``"probe"`` ...), the variant (hashable; None for a source without
    one) and, for a source built with a parameter block's values compiled
    in, the block's dtype and bytes."""
    return (source, build, variant,
            None if block is None else (block.dtype,
                                        block.numpy().tobytes()))


def library(source: str, build: str, variant, path, bind,
            block: torch.Tensor | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``'s ``build`` for ``variant``
    (and ``block``), looked up by :func:`library_key`. The first look-up,
    in :func:`loading`, calls ``path()`` (the kernel module's
    ``library_path``: the generated header is written and the source built
    there, if needed), loads the file and returns ``bind(lib)`` (the C
    signatures set and the library checked against the module); every later
    one returns that same object and formats no header."""
    key = library_key(source, build, variant, block)
    lib = _LIBRARIES.get(key)
    if lib is None:
        with loading():
            lib = bind(load(path()))
        _LIBRARIES[key] = lib
    return lib


def loads() -> int:
    """Libraries this process has loaded (each built first if needed): the
    counter ``kernels.loads``. A call that raises it built or loaded a
    kernel library."""
    return trace.counter("kernels.loads")


@contextlib.contextmanager
def loading():
    """The whole first look-up of a library (:func:`library`): the span
    ``kernels.load``, whose seconds, less those of an ``nvcc`` build inside
    it, are added to ``kernels.load_s``."""
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


def launch(fn, *args, span: str | None = None,
           counter: str | None = None) -> None:
    """One launch: ``fn(*args)``, a C entry point of a loaded library that
    queues a kernel and returns its CUDA error, in the span ``span`` (none
    when None); a ``RuntimeError`` when the error is not 0; then one more on
    the counter ``launches.<counter>`` (none when None)."""
    if span is None:
        err = fn(*args)
    else:
        with trace.span(span):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    if counter is not None:
        trace.count(f"launches.{counter}")


# ---------------------------------------------------------------------------
# Launch checks
# ---------------------------------------------------------------------------

def check_cuda(tensors, where: str) -> torch.device | None:
    """The CUDA device a launch's fields lie on, or None when they lie on
    the CPU (the wrapper takes the plain version). Raises ``ValueError``
    for a ``DTensor`` (its ``data_ptr`` is not its shard's storage: a
    column-sharded state steps through the entry points of
    ``models/column.py``, which hand each rank's shard to the wrapper), and
    for CUDA fields that differ in device or dtype or are not contiguous;
    ``NotImplementedError`` for another device type."""
    if any(is_dtensor(t) for t in tensors):
        raise ValueError(f"{where}: a DTensor cannot be launched on; pass "
                         f"each rank's local shard (DTensor.to_local) or "
                         f"step through models/column.py")
    device = tensors[0].device
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise NotImplementedError(
            f"{where}: no kernel for device type {device.type!r}")
    for t in tensors:
        if t.device != device or t.dtype != tensors[0].dtype:
            raise ValueError(f"{where}: fields differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{where}: fields must be contiguous")
    return device


def check_tiling(ncol: int, block_cols: int) -> None:
    """Raise ``ValueError`` unless ``block_cols`` (the columns a thread
    block steps) is at least 1 and divides ``ncol``."""
    if block_cols < 1 or ncol % block_cols:
        raise ValueError(
            f"ncol={ncol} not a multiple of block_cols={block_cols}")


def check_fields(fields, block_cols: int, where: str) -> torch.device | None:
    """:func:`check_cuda` of a launch on ``(ncol, nlev)`` fields, the first
    giving the shape, after :func:`check_tiling` of ``ncol`` and a
    ``ValueError`` for a field of another shape."""
    ncol, nlev = fields[0].shape
    check_tiling(ncol, block_cols)
    for t in fields:
        if t.shape != (ncol, nlev):
            raise ValueError(f"every field must be {(ncol, nlev)}, "
                             f"got {tuple(t.shape)}")
    return check_cuda(fields, where)


def check_packed(packed: torch.Tensor, n_fields: int, block_cols: int,
                 where: str) -> torch.device | None:
    """:func:`check_cuda` of a launch on a packed ``(n_fields, ncol, nlev)``
    state, after a ``ValueError`` for another shape and
    :func:`check_tiling` of ``ncol``."""
    if packed.dim() != 3 or packed.shape[0] != n_fields:
        raise ValueError(f"packed state must be ({n_fields}, ncol, nlev), "
                         f"got {tuple(packed.shape)}")
    check_tiling(packed.shape[1], block_cols)
    return check_cuda([packed], where)


def affine(q_tot_affine) -> tuple:
    """The launch arguments of an optional ``(scale, bias)`` of ``q_tot``
    on load: ``(1, scale, bias)``, or ``(0, 0.0, 0.0)`` for None."""
    if q_tot_affine is None:
        return 0, 0.0, 0.0
    scale, bias = q_tot_affine
    return 1, float(scale), float(bias)


def fit_block_cols(ncol: int, block_cols: int) -> int:
    """The columns a thread block steps on ``ncol`` columns:
    ``max(block_cols, 1)``, halved until it divides ``ncol`` (for a power of
    two, the largest power of two up to ``block_cols`` that divides
    ``ncol``)."""
    bc = max(block_cols, 1)
    while ncol % bc:
        bc //= 2
    return bc


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
