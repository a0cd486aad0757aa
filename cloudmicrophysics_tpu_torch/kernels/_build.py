"""Build and load the CUDA kernels of this package.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Nothing is built when this module is imported: the build
happens at the first launch, into ``build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source, the generated header and
the flags, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
CSRC_DIR = KERNELS_DIR / "csrc"
BUILD_DIR = KERNELS_DIR / "build"

# Parity with the eager PyTorch step comes first: no fast math, and no
# contraction of a*b+c into one FMA, so the kernel rounds operation by
# operation as the eager code does.
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


def index_header(names, guard: str) -> str:
    """A C header with ``#define P_<name> <index>`` for each name and
    ``N_PARAMS``: the device-side view of a parameter buffer's order."""
    lines = [f"// Generated from the parameter list of the kernel's Python "
             f"module; do not edit.",
             f"#ifndef {guard}", f"#define {guard}"]
    lines += [f"#define P_{name} {i}" for i, name in enumerate(names)]
    lines += [f"#define N_PARAMS {len(names)}", "#endif", ""]
    return "\n".join(lines)


def build(source: str, header_name: str, header_text: str) -> Path:
    """Compile ``csrc/<source>`` (with the generated header) and return
    the path of the shared library; reuse it when it already exists."""
    src = CSRC_DIR / source
    key = hashlib.sha256(
        src.read_bytes() + header_text.encode() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{src.stem}-{key}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / header_name).write_text(header_text)
    tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n"
            + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: str, header_name: str, header_text: str) -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build(source, header_name, header_text)))
