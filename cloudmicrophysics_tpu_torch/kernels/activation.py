"""ARG2000 activation as two hand-written CUDA kernels: the host side.

``csrc/activation.cu`` computes, per point and in one pass over its inputs,
what :func:`..ops.aerosol_activation.N_activated_per_mode` (the activated
number of each mode) and :func:`..ops.aerosol_activation.M_activated_per_mode`
(the activated mass) compute in eager PyTorch, maximum supersaturation
included: one launch a call, named ``arg2000_number_elementwise_kernel``
and ``arg2000_mass_elementwise_kernel``. The eager functions call
:func:`activated` for a state on a CUDA device and keep their own code as
the plain version, which CPU tensors take.

What a launch takes (:func:`launch_params`): float32 or float64, any
number of points and modes, ``ModeKappa`` and ``ModeB`` modes. The state's
shape is the broadcast of every tensor among the fields; each field is read
as its :func:`field_kind` says:

* ``"number"``: a Python number, its value in the parameter block;
* ``"one"``: a one-element tensor, read through its pointer by every point
  (no copy to the host);
* ``"full"``: a contiguous tensor of the state's shape, a value a point;
* ``"broadcast"``: any other tensor, expanded to the state's shape and made
  contiguous first.

Tensors lie on the state's device in its dtype; ``T``, ``p`` and ``q_tot``
are tensors, and the parameters (``ap``, ``aip``, ``tps``) Python numbers;
no field requires a gradient while autograd records. Anything else raises:
a CUDA state never falls back to the plain version.

One build of the source serves a dtype and a layout (:class:`Launch`,
:func:`header`): the number of modes, each field's kind (a number, one
value, a value a point), each mode's product pairs and how each exponent is
lowered, all compiled in, so that the kernel decides no branch on them while
it runs; the values, numbers and pointers, are the parameter block's,
passed at each launch. Each build is made at its layout's first launch and
kept on disk (``kernels/_build.py``); a host model's every step has one
layout.

Bit-identity with the plain version: the eager code's Python arithmetic on
constants is folded here in double (:func:`kernel_constants`) and rounded
once on the card; a mode's hygroscopicity and mass are Python sums of
products, whose leading terms of Python numbers Python adds in double
(:func:`sum_terms`); a ``ModeB`` mode's hygroscopicity is
``mean_hygroscopicity_parameter``'s value, passed whole; each exponent is
lowered as torch lowers it (:func:`pow_code`).

Each launch is the span ``launch.arg_number`` or ``launch.arg_mass`` and
adds one to ``launches.arg_number`` or ``launches.arg_mass``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import trace
from ..ops.aerosol_activation import mean_hygroscopicity_parameter
from ..parallel.comms import is_dtensor
from ..parameters.aerosol import AerosolDistribution, ModeB, ModeKappa
from ..utils.special import eps_numerics, machine_eps
from . import _build

__all__ = [
    "Launch",
    "PARAM_NAMES",
    "activated",
    "broadcast_shape",
    "field_kind",
    "hygroscopicity",
    "kernel_constants",
    "launch_params",
    "pow_code",
    "sum_terms",
]

SOURCE = "activation.cu"
BUILD_FLAGS = ("-lineinfo",)

# the constants of the parameter block, in the order of csrc's P_<name>
PARAM_NAMES = (
    # thresholds of the dtype
    "EPS", "EPS_N",
    # thermodynamics
    "T_0", "DCP_VL", "LH_V0", "DCP_VI", "LH_S0", "R_D", "RV_RD", "CP_D",
    "CPVD", "CPLV", "CPIV", "CPLV_QL", "CPIV_QI", "R_V", "INV_R_V",
    "INV_TT", "PRESS_TRIPLE", "KL1", "KL2", "KI1", "KI2",
    # air
    "INV_K_THERM", "INV_D_VAPOR",
    # ARG2000
    "INV_RHO_W", "INV_RHO_I", "G", "CA", "THIRD", "E_CRIT", "P1", "P2",
    "F1", "F2", "G1", "G2", "CE", "INV_43PI", "CKL", "CKI",
)

AIR = ("T", "p", "w", "q_tot", "q_liq", "q_ice", "N_liq", "N_ice")
# the air fields that must be tensors: as Python numbers the eager code
# would fold them with its constants into other operations
TENSOR_AIR = ("T", "p", "q_tot")
MODE_FIELDS = 5            # N, r_dry, stdev, hygroscopicity, mass
# a parameter block's fields at most: it is passed by value, within CUDA's
# 32,764 bytes of kernel parameters
MAX_FIELDS = 1024
# each field's kind as csrc's Kind numbers it
KINDS = {"number": 0, "one": 1, "full": 2, "broadcast": 2}

# torch's lowering of x ** e for a Python-number e (csrc's pow_scalar):
# fill with 1, copy, sqrt, rsqrt, reciprocal, products; 0 is powf
_POW_CODES = {0.0: 1, 1.0: 2, 0.5: 3, -0.5: 4, -1.0: 5, 2.0: 6, 3.0: 7,
              -2.0: 8}


class Launch(NamedTuple):
    """A launch's parameter block (its output not yet set), the layout its
    library is built for, the state's shape and the tensors the block
    points to. ``layout``: ``(kinds, hyg_first, hyg_count, mass_first,
    mass_count, pow_codes)``, each a tuple of ints: every field's kind
    (:data:`KINDS`), each mode's first field and count of
    hygroscopicity and of mass product pairs, each exponent's
    :func:`pow_code`."""

    params: ctypes.Structure
    layout: tuple
    shape: tuple
    keep: list


@functools.lru_cache(maxsize=None)
def params_type(dtype: torch.dtype, n_fields: int) -> type:
    """The ``ctypes`` structure of csrc's ``Params`` in a build for
    ``dtype`` with ``n_fields`` fields: each field's pointer, its Python
    number and that number's reciprocal (in the build's type), the
    constants, the points and the output."""
    check_dtype(dtype)
    S = _build.c_scalar(dtype)

    class Field(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p), ("val", S), ("inv", S)]

    class Params(ctypes.Structure):
        _fields_ = [("f", Field * n_fields), ("c", S * len(PARAM_NAMES)),
                    ("n", ctypes.c_longlong), ("out", ctypes.c_void_p)]

    return Params


def pow_code(e: float) -> int:
    """How torch raises a tensor to the Python number ``e``: 0 for ``powf``
    (``pow``), else the code of its special case (csrc's ``pow_scalar``)."""
    return _POW_CODES.get(float(e), 0)


def _number(value, name: str) -> float:
    if isinstance(value, torch.Tensor) or not isinstance(value, (int, float)):
        raise NotImplementedError(
            f"the CUDA ARG2000 kernels take {name} as a Python number, not "
            f"{type(value).__name__}")
    return value


def kernel_constants(ap, aip, tps, dtype: torch.dtype, q_liq=0.0,
                     q_ice=0.0) -> dict:
    """The parameter block's constants by :data:`PARAM_NAMES`, in double:
    each the value of the eager code's Python expression that gives it (so
    the kernel rounds each once, as PyTorch rounds a Python scalar), with
    ``dtype``'s thresholds. ``CPLV_QL``, ``CPIV_QI``: ``cp_m``'s products
    with a Python-number ``q_liq``, ``q_ice`` (0 for tensors, which the
    kernel multiplies itself)."""
    for obj, names in ((ap, ("M_w", "R", "rho_w", "rho_i", "sigma", "g", "f1",
                             "f2", "g1", "g2", "p1", "p2")),
                       (aip, ("K_therm", "D_vapor")),
                       (tps, ("gas_constant", "molmass_dryair",
                              "molmass_water", "kappa_d", "cp_v", "cp_l",
                              "cp_i", "LH_v0", "LH_s0", "T_0", "T_triple",
                              "press_triple"))):
        for n in names:
            _number(getattr(obj, n), n)
    eps_n = eps_numerics(dtype)
    dcp_vl, dcp_vi = tps.cp_v - tps.cp_l, tps.cp_v - tps.cp_i
    cplv, cpiv = tps.cp_l - tps.cp_v, tps.cp_i - tps.cp_v
    tensor_ql = isinstance(q_liq, torch.Tensor)
    tensor_qi = isinstance(q_ice, torch.Tensor)
    c = dict(
        EPS=machine_eps(dtype), EPS_N=eps_n,
        T_0=tps.T_0, DCP_VL=dcp_vl, LH_V0=tps.LH_v0, DCP_VI=dcp_vi,
        LH_S0=tps.LH_s0, R_D=tps.R_d, RV_RD=tps.Rv_over_Rd, CP_D=tps.cp_d,
        CPVD=tps.cp_v - tps.cp_d, CPLV=cplv, CPIV=cpiv,
        CPLV_QL=0.0 if tensor_ql else cplv * q_liq,
        CPIV_QI=0.0 if tensor_qi else cpiv * q_ice,
        R_V=tps.R_v, INV_R_V=1 / tps.R_v,
        INV_TT=1 / tps.T_triple, PRESS_TRIPLE=tps.press_triple,
        KL1=dcp_vl / tps.R_v, KL2=(tps.LH_v0 - dcp_vl * tps.T_0) / tps.R_v,
        KI1=dcp_vi / tps.R_v, KI2=(tps.LH_s0 - dcp_vi * tps.T_0) / tps.R_v,
        INV_K_THERM=1 / max(aip.K_therm, eps_n),
        INV_D_VAPOR=1 / max(aip.D_vapor, eps_n),
        INV_RHO_W=1 / ap.rho_w, INV_RHO_I=1 / ap.rho_i, G=ap.g,
        CA=2 * ap.sigma * ap.M_w / ap.rho_w / ap.R,
        THIRD=1 / 3, E_CRIT=1.5, P1=ap.p1, P2=ap.p2,
        F1=ap.f1, F2=ap.f2, G1=ap.g1, G2=ap.g2,
        CE=2 * math.pi * ap.rho_w, INV_43PI=1 / (4 / 3 * math.pi),
        CKL=4 * math.pi * ap.rho_w, CKI=4 * math.pi,
    )
    assert tuple(c) == PARAM_NAMES
    return {k: float(v) for k, v in c.items()}


def _kind(value, shape: tuple, device: torch.device, dtype: torch.dtype,
          name: str) -> str:
    """:func:`field_kind`'s kind of ``value``, with its checks; nothing is
    materialised."""
    if isinstance(value, torch.Tensor):
        if is_dtensor(value):
            raise ValueError(f"{name}: a DTensor cannot be launched on")
        if value.device != device or value.dtype != dtype:
            raise ValueError(
                f"{name}: the CUDA ARG2000 kernels take tensors on {device} "
                f"of {dtype}, not on {value.device} of {value.dtype}")
        if value.numel() == 1:
            return "one"
        if tuple(value.shape) == tuple(shape) and value.is_contiguous():
            return "full"
        return "broadcast"
    if isinstance(value, (int, float)):
        return "number"
    raise TypeError(f"{name}: a Python number or a tensor, not "
                    f"{type(value).__name__}")


def field_kind(value, shape: tuple, device: torch.device,
               dtype: torch.dtype, name: str = "field"):
    """``(kind, value)``: how a launch on a state of ``shape`` on
    ``device`` in ``dtype`` reads the field ``value`` (module docstring):
    ``("number", float)``, ``("one", tensor)``, ``("full", tensor)`` or
    ``("broadcast", tensor)``, the last expanded and made contiguous.
    Raises ``ValueError`` for a tensor on another device, of another dtype
    or a ``DTensor``, ``TypeError`` for what is neither a number nor a
    tensor."""
    kind = _kind(value, shape, device, dtype, name)
    if kind == "number":
        return kind, float(value)
    if kind == "broadcast":
        return kind, value.expand(shape).contiguous()
    return kind, value


def sum_terms(pairs) -> tuple:
    """``(start, terms)`` of Python's ``sum(a * b for a, b in pairs)`` as
    the eager code evaluates it: Python adds the products of Python numbers
    in double until the first tensor product (``start``, 0 when that is the
    first), after which each product joins the sum on the device in order
    (``terms``: ``(a, b)`` pairs, a later product of two numbers folded to
    ``(a * b, 1.0)``, which the kernel's multiply by 1 leaves as it is)."""
    start, terms = 0, []
    for a, b in pairs:
        numbers = not isinstance(a, torch.Tensor) and not isinstance(
            b, torch.Tensor)
        if numbers and not terms:
            start = start + a * b
        elif numbers:
            terms.append((a * b, 1.0))
        else:
            terms.append((a, b))
    return start, terms


def hygroscopicity(ap, mode) -> tuple:
    """A mode's hygroscopicity as :func:`sum_terms` gives it: a
    ``ModeKappa`` mode's sum of volume fraction times kappa, a ``ModeB``
    mode's ``mean_hygroscopicity_parameter`` whole (``(value, [])``)."""
    if isinstance(mode, ModeKappa):
        return sum_terms(zip(mode.vol_mix_ratio, mode.kappa))
    if isinstance(mode, ModeB):
        return mean_hygroscopicity_parameter(
            ap, AerosolDistribution(modes=(mode,)))[0], []
    raise TypeError(f"unknown mode type {type(mode)}")


def check_dtype(dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` unless the kernels are built for
    ``dtype``: float32 or float64."""
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"the CUDA ARG2000 kernels support float32 and float64, not "
            f"{dtype}")


def broadcast_shape(shapes) -> tuple:
    """The shape ``shapes`` broadcast to, by NumPy's rule (what
    ``torch.broadcast_shapes`` gives, without the symbolic-shape modules
    that it imports at its first call, seconds of a process's set-up).
    Raises ``ValueError`` for shapes that do not broadcast."""
    ndim = max((len(s) for s in shapes), default=0)
    out = [1] * ndim
    for s in shapes:
        for k, d in enumerate(s, ndim - len(s)):
            if d != 1 and out[k] != d:
                if out[k] != 1:
                    raise ValueError(f"shapes {sorted(shapes)} do not "
                                     f"broadcast")
                out[k] = d
    return tuple(out)


def launch_params(ap, ad, aip, tps, air, mass: bool) -> Launch:
    """The :class:`Launch` of the mass kernel (``mass``) or the number
    kernel on the air ``(T, p, w, q_tot, q_liq, q_ice, N_liq, N_ice)`` and
    ``ad``'s modes. Both kernels of a distribution share the layout: the
    number kernel's block leaves the mass pairs, which it does not read,
    unset. The state's device and dtype are those of the first tensor on a
    CUDA device among the fields (of ``T`` when none is). Raises for what
    the kernels cannot take, a field that requires a gradient while
    autograd records included."""
    for name, v in zip(AIR, air):
        if name in TENSOR_AIR and not isinstance(v, torch.Tensor):
            raise NotImplementedError(
                f"the CUDA ARG2000 kernels take {name} as a tensor")
    if not ad.modes:
        raise NotImplementedError("the CUDA ARG2000 kernels need a mode")
    values, names, sums = list(air), list(AIR), []
    for m, mode in enumerate(ad.modes):
        hyg = hygroscopicity(ap, mode)
        mass_sum = sum_terms(zip(mode.molar_mass, mode.mass_mix_ratio))
        values += (mode.N, mode.r_dry, mode.stdev, hyg[0], mass_sum[0])
        names += [f"modes[{m}].{k}" for k in ("N", "r_dry", "stdev",
                                               "hygroscopicity", "mass")]
        sums.append((hyg[1], mass_sum[1]))
    first, unread = [], set()
    for m, (hyg_terms, mass_terms) in enumerate(sums):
        for terms, what, read in (
                (hyg_terms, ("vol_mix_ratio", "kappa"), True),
                (mass_terms, ("molar_mass", "mass_mix_ratio"), mass)):
            first.append(len(values))
            if not read:
                unread.update(range(len(values), len(values) + 2 * len(terms)))
            for pair in terms:
                values += pair
                names += [f"modes[{m}].{w}" for w in what]
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    state = next((t for t in tensors if t.device.type == "cuda"), air[0])
    device, dtype = state.device, state.dtype
    check_dtype(dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA ARG2000 kernels track no gradient: call the plain "
            "version (*_activated_per_mode_plain) to differentiate, or "
            "launch under torch.no_grad()")
    if len(values) > MAX_FIELDS:
        raise NotImplementedError(
            f"the CUDA ARG2000 kernels take {MAX_FIELDS} fields, not "
            f"{len(values)}")

    shape = broadcast_shape({tuple(t.shape) for t in tensors})
    p = params_type(dtype, len(values))()
    kinds, keep = [], []
    for k, (f, name, v) in enumerate(zip(p.f, names, values)):
        if k in unread:
            kinds.append(KINDS[_kind(v, shape, device, dtype, name)])
            continue
        kind, x = field_kind(v, shape, device, dtype, name)
        kinds.append(KINDS[kind])
        if kind == "number":
            f.val = x
            f.inv = 1 / x if x else math.copysign(math.inf, x)
        else:
            f.ptr = x.data_ptr()
            keep.append(x)
    p.c[:] = list(kernel_constants(ap, aip, tps, dtype, air[4],
                                   air[5]).values())
    p.n = math.prod(shape)
    # critical_supersaturation's 1.5, the ARG fit's p1 and p2, the
    # condensate radii's 1/3 (csrc's PowSlot order)
    pows = tuple(pow_code(e) for e in (1.5, ap.p1, ap.p2, 1 / 3))
    layout = (tuple(kinds), tuple(first[0::2]),
              tuple(len(h) for h, _ in sums), tuple(first[1::2]),
              tuple(len(ms) for _, ms in sums), pows)
    return Launch(p, layout, shape, keep)


def header(dtype: torch.dtype, layout: tuple) -> str:
    """The generated header of the build for ``dtype`` and ``layout``
    (:class:`Launch`): ``#define P_<name>`` the index of each constant of
    :data:`PARAM_NAMES`, ``ARG_REAL`` (the scalar type), the layout as
    ``ARG_MODES``, ``ARG_FIELDS``, ``ARG_KINDS``, ``ARG_HYG_FIRST``,
    ``ARG_HYG_COUNT``, ``ARG_MASS_FIRST``, ``ARG_MASS_COUNT`` and
    ``ARG_POW``, and ``N_PARAMS``."""
    check_dtype(dtype)
    kinds, hyg_first, hyg_count, mass_first, mass_count, pows = layout

    def ints(xs):
        return ", ".join(str(int(x)) for x in xs)

    return _build.index_header(PARAM_NAMES, "ACTIVATION_PARAMS_H", (
        ("ARG_REAL", _build.c_type(dtype)), ("ARG_MODES", len(hyg_first)),
        ("ARG_FIELDS", len(kinds)), ("ARG_KINDS", ints(kinds)),
        ("ARG_HYG_FIRST", ints(hyg_first)), ("ARG_HYG_COUNT", ints(hyg_count)),
        ("ARG_MASS_FIRST", ints(mass_first)),
        ("ARG_MASS_COUNT", ints(mass_count)), ("ARG_POW", ints(pows))))


def library_path(dtype: torch.dtype, layout: tuple):
    """The file of the build for ``dtype`` and ``layout`` (built if
    needed)."""
    return _build.build(SOURCE, "activation_params.h",
                        header(dtype, layout),
                        BUILD_FLAGS + _build.dtype_flags(dtype))


def bind(lib: ctypes.CDLL, dtype: torch.dtype, layout: tuple) -> ctypes.CDLL:
    """Set the C signatures of a loaded build for ``dtype`` and ``layout``
    and check it against this module; returns it."""
    _I, _P = ctypes.c_int, ctypes.c_void_p
    lib.arg2000_launch.argtypes = [_I, _P, _I, _P]
    lib.arg2000_launch.restype = _I
    lib.arg2000_kernel_attrs.argtypes = [_I, _I, _P, _P, _P]
    lib.arg2000_kernel_attrs.restype = _I
    checks = {"arg2000_num_params": len(PARAM_NAMES),
              "arg2000_real_bytes": dtype.itemsize,
              "arg2000_params_bytes": ctypes.sizeof(
                  params_type(dtype, len(layout[0]))),
              "arg2000_modes": len(layout[1])}
    for fn, want in checks.items():
        getattr(lib, fn).restype = _I
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"activation library: {fn}() is not {want}: "
                               f"built for another layout or dtype")
    lib.arg2000_threads_per_block.restype = _I
    return lib


def _library(dtype: torch.dtype, layout: tuple) -> ctypes.CDLL:
    """The build for ``dtype`` and ``layout``, loaded and bound
    (:func:`_build.library`)."""
    return _build.library(SOURCE, "kernel", (str(dtype), layout),
                          lambda: library_path(dtype, layout),
                          lambda lib: bind(lib, dtype, layout))


def kernel_attrs(dtype: torch.dtype, layout: tuple, mass: bool,
                 device: int = 0) -> dict:
    """Registers and local memory bytes per thread, threads per block and
    resident blocks per SM of the number (or ``mass``) kernel's build for
    ``dtype`` and ``layout``."""
    lib = _library(dtype, layout)
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.arg2000_kernel_attrs(int(mass), device, ctypes.byref(regs),
                                   ctypes.byref(local), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"arg2000 kernel attributes: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value,
            "threads": lib.arg2000_threads_per_block(),
            "blocks_per_sm": blocks.value}


def activated(ap, ad, aip, tps, air, mass: bool) -> tuple:
    """Each mode's activated number (or, with ``mass``, mass) on a CUDA
    state: one launch of the kernel (module docstring), in the span
    ``activation.smax`` (the kernel computes the maximum supersaturation),
    which adds the points to ``activation.smax_points``. Returns the
    tuple of outputs, one a mode, of the state's broadcast shape."""
    params, layout, shape, keep = launch_params(ap, ad, aip, tps, air, mass)
    T = keep[0]             # the state's T, on its device in its dtype
    lib = _library(T.dtype, layout)
    out = torch.empty((len(ad.modes),) + shape, dtype=T.dtype,
                      device=T.device)
    if params.n:
        params.out = out.data_ptr()
        kind = "arg_mass" if mass else "arg_number"
        stream = torch.cuda.current_stream(T.device).cuda_stream
        with trace.span("activation.smax"), _build.launching(lib):
            _build.launch(lib.arg2000_launch, int(mass), ctypes.byref(params),
                          T.device.index, stream, span=f"launch.{kind}",
                          counter=kind)
    trace.count("activation.smax_points", params.n)
    return tuple(out.unbind(0))
