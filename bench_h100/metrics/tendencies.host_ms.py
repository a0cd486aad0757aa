"""``tendencies.host_ms``: host milliseconds a step inside the program's
P3 tendency route, the span ``tendencies.p3`` (``bulk_tendencies_2m`` on
CUDA fields) that the program records while the profiler records the
window: its total over the window per step. None for a program that
records no such span."""

from bench_h100.spans import per_step_ms


def read(view):
    return per_step_ms(view, names=("tendencies.p3",))
