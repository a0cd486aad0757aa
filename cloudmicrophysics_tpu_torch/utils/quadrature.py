"""Quadrature rules for the P3 size-distribution integrals.

Port of ``cloudmicrophysics_tpu/utils/quadrature.py`` (reference
``src/Quadrature.jl``):

* :class:`ChebyshevGauss` — closed-form nodes/weights (reference
  ``src/Quadrature.jl:166-173``);
* :class:`GaussLegendre` — nodes/weights computed on the host once, in
  float64 (``numpy.polynomial.legendre.leggauss``), as the reference builds
  them (``src/Quadrature.jl:227-255``);
* :class:`Tabulated` — a rule whose tables are stored on it, the form the
  P3 parameters carry (the JAX package makes it a pytree so the tables can
  ride into a Pallas kernel as operands; here it is a plain class).

Node and weight tables stay host-side float64 numpy arrays; they become
tensors of the bounds' dtype and device where a rule is applied.
:func:`integrate` evaluates the integrand over a new leading node axis and
sums over it; the P3 consumers of a node table add its node axis with
:func:`sum_nodes`, one node at a time in node order, so that a kernel
visiting the nodes in the same order adds them alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from .special import float_dtype

__all__ = [
    "ChebyshevGauss",
    "GaussLegendre",
    "QuadratureRule",
    "Tabulated",
    "build_quadrature",
    "default_quadrature",
    "integrate",
    "integrate_segments",
    "nodes",
    "segment_nodes",
    "sum_nodes",
    "tabulate",
]


@dataclasses.dataclass(frozen=True)
class QuadratureRule:
    n: int


@dataclasses.dataclass(frozen=True)
class ChebyshevGauss(QuadratureRule):
    """Chebyshev-Gauss (first kind): ``y_i = cos(pi (2i-1)/(2n))``,
    ``w_i = pi/n``, ``1/w(y) = sqrt(1 - y^2)``."""

    def nodes_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        i = np.arange(1, self.n + 1, dtype=np.float64)
        y = np.cos(np.pi * (2 * i - 1) / (2 * self.n))
        w = (np.pi / self.n) * np.sqrt(np.maximum(1.0 - y * y, 0.0))
        return y, w


@dataclasses.dataclass(frozen=True)
class GaussLegendre(QuadratureRule):
    """Gauss-Legendre; nodes/weights built on the host in float64."""

    def nodes_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        y, w = np.polynomial.legendre.leggauss(self.n)
        return y.astype(np.float64), w.astype(np.float64)


class Tabulated:
    """A quadrature rule with its node/weight tables stored on it.

    The tables are float64 numpy arrays of shape ``(n, 1, 1)``, node axis
    first, as :func:`tabulate` makes them (the JAX package bakes in the two
    unit axes for its ``(ncol, nlev)`` tiles; :func:`nodes` accepts any
    shape with ``n`` entries)."""

    def __init__(self, n: int, y, w):
        self.n = n
        self.y = y
        self.w = w

    def nodes_weights(self):
        return self.y, self.w

    def __eq__(self, other):
        return (isinstance(other, Tabulated) and self.n == other.n
                and np.array_equal(self.y, other.y)
                and np.array_equal(self.w, other.w))

    def __hash__(self):
        return hash((self.n, np.asarray(self.y).tobytes(),
                     np.asarray(self.w).tobytes()))

    def __repr__(self):
        return f"Tabulated(n={self.n})"


def tabulate(rule: QuadratureRule) -> Tabulated:
    """Materialize a rule's float64 tables on the host once."""
    y, w = rule.nodes_weights()
    return Tabulated(rule.n, y.reshape(-1, 1, 1), w.reshape(-1, 1, 1))


def build_quadrature(order: int) -> QuadratureRule:
    """Gauss-Legendre for the preferred orders {4, 8, 16, 32, 40, 64},
    Chebyshev-Gauss otherwise (reference ``src/Quadrature.jl:272-278``;
    {4, 8} extend the reference's GL set downward)."""
    if order in (4, 8, 16, 32, 40, 64):
        return GaussLegendre(order)
    return ChebyshevGauss(order)


def default_quadrature() -> QuadratureRule:
    """Reference default: ``ChebyshevGauss(100)`` (src/Quadrature.jl:62)."""
    return ChebyshevGauss(100)


def _table(arr, like: torch.Tensor) -> torch.Tensor:
    """A node table as a tensor of ``like``'s dtype and device, shaped to
    broadcast over ``like`` with a new leading node axis."""
    t = torch.as_tensor(np.asarray(arr, dtype=np.float64).reshape(-1),
                        dtype=like.dtype, device=like.device)
    return t.reshape((-1,) + (1,) * like.dim())


def _bounds(a, b):
    dt = float_dtype(a, b)
    device = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
                  None)
    a = torch.as_tensor(a, dtype=dt, device=device)
    b = torch.as_tensor(b, dtype=dt, device=device)
    return torch.broadcast_tensors(a, b)


def integrate(f: Callable, a, b, quad: QuadratureRule | None = None):
    """Approximate ``\\int_a^b f(x) dx`` with the given rule.

    ``a`` and ``b`` may be tensors (per-cell bounds); ``f`` must accept a
    tensor with one extra leading node axis. Returns 0 where ``a >= b`` or
    bounds are NaN (reference ``src/Quadrature.jl:62-87``).
    """
    if quad is None:
        quad = default_quadrature()
    y_np, w_np = quad.nodes_weights()
    a, b = _bounds(a, b)
    valid = a < b
    # dead-branch sanitization: invalid/NaN bounds evaluate f on [1, 2]
    a_s = torch.where(valid, a, torch.ones_like(a))
    b_s = torch.where(valid, b, 2 * torch.ones_like(b))
    y = _table(y_np, a)
    w = _table(w_np, a)
    scale = (b_s - a_s) / 2
    shift = (a_s + b_s) / 2
    x = scale * y + shift
    res = torch.sum(f(x) * w, dim=0) * scale
    return torch.where(valid, res, torch.zeros_like(res))


def nodes(quad: QuadratureRule, a, b):
    """Quadrature nodes/weights mapped to ``[a, b]`` with a new LEADING
    axis: summing ``f(x) * w_scaled`` over axis 0 approximates the
    integral. Invalid (``a >= b``) windows get zero weights (and the
    dead-branch nodes are sanitized onto ``[1, 2]``)."""
    y_np, w_np = quad.nodes_weights()
    a, b = _bounds(a, b)
    valid = a < b
    a_s = torch.where(valid, a, torch.ones_like(a))
    b_s = torch.where(valid, b, 2 * torch.ones_like(b))
    y = _table(y_np, a)
    w = _table(w_np, a)
    scale = (b_s - a_s) / 2
    x = scale * y + (a_s + b_s) / 2
    w_scaled = w * scale
    return x, torch.where(valid, w_scaled, torch.zeros_like(w_scaled))


def segment_nodes(quad: QuadratureRule, bnds):
    """Concatenate :func:`nodes` tables over consecutive segments of a
    bounds tuple along the leading axis — the shared-node form of
    :func:`integrate_segments` (evaluate integrands once at ``(x, w)``,
    contract many different moments against the same table)."""
    xs, ws = [], []
    for lo, hi in zip(bnds[:-1], bnds[1:]):
        x, w = nodes(quad, lo, hi)
        xs.append(x)
        ws.append(w)
    return torch.cat(xs, dim=0), torch.cat(ws, dim=0)


def integrate_segments(f: Callable, bnds, quad: QuadratureRule | None = None):
    """Integrate ``f`` over consecutive subintervals of a bounds tuple.

    ``integrate_segments(f, (a, b, c)) = \\int_a^b f + \\int_b^c f``
    (reference ``src/Quadrature.jl:101-125``). Each segment with
    ``lo >= hi`` (e.g. collapsed or NaN bounds) contributes zero.
    """
    total = None
    for lo, hi in zip(bnds[:-1], bnds[1:]):
        part = integrate(f, lo, hi, quad)
        total = part if total is None else total + part
    return total


def sum_nodes(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (node) axis one node at a time, in node order."""
    parts = x.unbind(0)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total
