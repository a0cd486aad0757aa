"""The roofline's kernels: a streaming copy and a chained-``expf`` probe,
as hand-written CUDA, beside their plain PyTorch versions.

* :func:`copy_step` — ``y = x * s + 1e-12`` into a separate output: the
  port of the Pallas copy kernel of ``benchmarks/roofline.py``
  (``copy_kernel``/``copy_step``, K6) and of its two scratch copies,
  ``benchmarks/scratch/perf_roof.py`` (K6b, which passes the scale
  directly) and ``perf_roof2.py`` (K6c, on an all-ones input). It measures
  the card's copy roof: one read and one write of every element.
* :func:`exp_chain_step` — ``x <- x * (1 + 1e-7 s)``, then ``chain`` times
  ``x <- exp(-x)``: the JAX harness's chained-``exp`` probe
  (``benchmarks/roofline.py:150``, plain ``jnp`` there), fused into one
  kernel so that it measures the rate of ``expf`` on the SMs and not 2 x
  ``chain`` passes over device memory.

Both live in ``csrc/roof.cu``. A CPU tensor takes the plain version
(:func:`copy_step_plain`, :func:`exp_chain_plain`). A CUDA tensor launches
the kernel, or raises ``NotImplementedError`` for a dtype other than
float32 or a tensor that is not contiguous: there is no fallback. Both
kernels are bit-identical to their plain versions on the card (the multiply
and the add round separately, and ``expf`` is the one PyTorch's CUDA
``exp`` calls).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "CHAIN",
    "copy_step",
    "copy_step_plain",
    "exp_chain_plain",
    "exp_chain_step",
    "scale_of",
]

# the length of the JAX harness's exp chain (benchmarks/roofline.py:148)
CHAIN = 64

SOURCE = "roof.cu"
# nvcc flags of each build of the source (-lineinfo maps each SASS
# instruction to its source line for kernels/opcount.py)
BUILDS = {"kernel": ("-lineinfo",)}
# the source has no generated parameters; the build writes this header
_HEADER = ("roof_params.h", "// roof.cu has no generated parameters\n")
# the C entry-point prefixes of the two kernels (_build.kernel_attrs)
PREFIXES = ("copy_scale", "exp_chain")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def scale_of(s, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``1 + 1e-7 * s`` as a 0-d tensor of ``dtype``, every constant and
    operation rounded there: what the JAX harness computes from a float32
    ``s`` (``1.0 + 1e-7 * s``, benchmarks/roofline.py:128 and :151)."""
    def t(v):
        return torch.tensor(v, dtype=dtype)

    return t(1.0) + t(1e-7) * t(s)


# ---------------------------------------------------------------------------
# Plain versions (eager PyTorch): the CPU path and the kernels' reference
# ---------------------------------------------------------------------------

def copy_step_plain(x: torch.Tensor, s) -> torch.Tensor:
    """What :func:`copy_step` computes, in eager PyTorch (two passes): the
    body of the Pallas kernel, ``x * s + 1e-12``. ``s``: a 0-d tensor or a
    number (rounded to ``x``'s dtype)."""
    return x * s + 1e-12


def exp_chain_plain(x: torch.Tensor, s, chain: int = CHAIN) -> torch.Tensor:
    """What :func:`exp_chain_step` computes, in eager PyTorch (``2 chain +
    1`` passes): ``x * (1 + 1e-7 s)`` (:func:`scale_of` in ``x``'s dtype),
    then ``chain`` times ``exp(-x)``."""
    x = x * scale_of(s, x.dtype)
    for _ in range(chain):
        x = torch.exp(-x)
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def library_path(build: str = "kernel"):
    """The file of one of the kernel library's :data:`BUILDS` (built if
    needed)."""
    return _build.build(SOURCE, *_HEADER, BUILDS[build])


def _library(build: str = "kernel") -> ctypes.CDLL:
    """One of the kernel library's :data:`BUILDS`, loaded (built at the
    first launch)."""
    lib = _build.load(SOURCE, *_HEADER, BUILDS[build])
    if not getattr(lib, "_signatures_set", False):
        lib.copy_scale.argtypes = [_P, _P, _L, _F, _I, _P]
        lib.exp_chain.argtypes = [_P, _P, _L, _F, _I, _I, _P]
        for prefix in PREFIXES:
            getattr(lib, f"{prefix}_blocks_per_sm").argtypes = [_I, _P]
            getattr(lib, f"{prefix}_kernel_attrs").argtypes = [_P, _P]
        for fn in (lib.copy_scale, lib.exp_chain,
                   *(getattr(lib, f"{p}_{name}") for p in PREFIXES
                     for name in ("blocks_per_sm", "kernel_attrs",
                                  "threads_per_block"))):
            fn.restype = _I
        lib._signatures_set = True
    return lib


def _check(x: torch.Tensor, where: str) -> None:
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"{where}: no kernel for device type {x.device.type!r}")
    if x.dtype != torch.float32:
        raise NotImplementedError(f"{where}: the kernel supports float32, "
                                  f"not {x.dtype}")
    if not x.is_contiguous():
        raise NotImplementedError(f"{where}: the kernel needs a contiguous "
                                  f"tensor")


def _launched(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def copy_step(x: torch.Tensor, s, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """``x * s + 1e-12`` into ``out`` (a new tensor when None), which must
    not overlap ``x``: the kernel ``copy_scale`` on a CUDA tensor,
    :func:`copy_step_plain` on a CPU tensor. ``s``: a float32 number or a
    0-d tensor, passed to the kernel by value."""
    if out is not None:
        if out.shape != x.shape or out.device != x.device \
                or out.dtype != x.dtype:
            raise ValueError("out must match x in shape, device and dtype")
        lo, hi = x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()
        olo = out.data_ptr()
        if x.numel() and olo < hi and lo < olo + out.numel() \
                * out.element_size():
            raise ValueError("out overlaps x: the copy is never in place")
    if x.device.type == "cpu":
        y = copy_step_plain(x, s)
        return y if out is None else out.copy_(y)
    _check(x, "copy_step")
    if out is None:
        out = torch.empty_like(x)
    _check(out, "copy_step (out)")
    err = _library().copy_scale(
        x.data_ptr(), out.data_ptr(), x.numel(), float(s), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "copy_scale")
    copy_step.launches += 1
    return out


copy_step.launches = 0


def exp_chain_step(x: torch.Tensor, s, chain: int = CHAIN) -> torch.Tensor:
    """``x * (1 + 1e-7 s)`` (:func:`scale_of`), then ``chain`` times
    ``exp(-x)``, into a new tensor: the kernel ``exp_chain`` on a CUDA
    tensor, :func:`exp_chain_plain` on a CPU tensor."""
    if chain < 0:
        raise ValueError(f"chain must be >= 0, got {chain}")
    if x.device.type == "cpu":
        return exp_chain_plain(x, s, chain)
    _check(x, "exp_chain_step")
    out = torch.empty_like(x)
    err = _library().exp_chain(
        x.data_ptr(), out.data_ptr(), x.numel(), float(scale_of(s)),
        int(chain), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "exp_chain")
    exp_chain_step.launches += 1
    return out


exp_chain_step.launches = 0
