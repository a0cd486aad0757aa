"""What the per-layer readers of the program's own spans and counters
share: the program's registry (``cloudmicrophysics_tpu_torch.trace``), read
once the traced window has closed. A program without one, as a checkout
from before it, gives None and each reader reads nothing."""

from __future__ import annotations


def registry():
    """The program's ``trace`` module, or None when it has none."""
    try:
        from cloudmicrophysics_tpu_torch import trace
    except ImportError:
        return None
    return trace


def per_step_ms(view, names=None, prefix=None):
    """Milliseconds a step of the window in the spans named ``names`` or
    beginning with ``prefix`` (their totals, each span's outermost entries
    only), or None when the program recorded none of them."""
    trace = registry()
    if trace is None or not view.steps:
        return None
    found = [t for n, t in trace.totals().items()
             if (names is not None and n in names)
             or (prefix is not None and n.startswith(prefix))]
    if not any(t["count"] for t in found):
        return None
    return 1e-6 * sum(t["total_ns"] for t in found) / view.steps
