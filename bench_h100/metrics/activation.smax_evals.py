"""``activation.smax_evals``: maximum-supersaturation evaluations a point
activated, the program's counters ``activation.smax_points`` (points whose
S_max was computed) over ``activation.points`` (points of each
``N_activated_per_mode`` call), over the whole process. 2.0 when the host's
number and mass calls each compute S_max; None for a program without the
counters."""

from bench_h100.spans import registry


def read(view):
    trace = registry()
    if trace is None:
        return None
    points = trace.counter("activation.points")
    if not points:
        return None
    return trace.counter("activation.smax_points") / points
