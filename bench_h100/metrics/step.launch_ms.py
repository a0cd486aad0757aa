"""``step.launch_ms``: host milliseconds a step in the program's kernel
launches, the spans ``launch.*`` around each call into a kernel library
(K1; K5a, K5b, K5c): their total over the traced window per step."""

from bench_h100.spans import per_step_ms


def read(view):
    return per_step_ms(view, prefix="launch.")
