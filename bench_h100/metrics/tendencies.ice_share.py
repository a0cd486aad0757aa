"""``tendencies.ice_share``: the share of the P3 tendency route's points
whose ice node pass ran, the program's counters ``tendencies.ice_points``
(points of K5b warps that hold ice, added on the device and read here)
over ``tendencies.kernel_points`` (points of the route's calls), over the
whole process. 1.0 where every point runs the node pass, 0.0 where none
does; None for a program without device counters (``trace.device_counter``,
which that counter needs) or without a kernel call."""

from bench_h100.spans import registry


def read(view):
    trace = registry()
    if trace is None or getattr(trace, "device_counter", None) is None:
        return None
    points = trace.counter("tendencies.kernel_points")
    if not points:
        return None
    return trace.counter("tendencies.ice_points") / points
