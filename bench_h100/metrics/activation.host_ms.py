"""``activation.host_ms``: host milliseconds a step inside the program's
activation entries, the spans ``activation.number``
(``N_activated_per_mode``) and ``activation.mass``
(``M_activated_per_mode``) that the program records while the profiler
records the window: their total over the window per step. None for a
program that records no such span."""

from bench_h100.spans import per_step_ms


def read(view):
    return per_step_ms(view, names=("activation.number", "activation.mass"))
