"""``device.idle``: share of the traced window in which no kernel runs on
the device."""

from bench_h100.harness import idle_share


def read(view):
    if not view.kernels:
        return None
    return idle_share([(a, b) for _, a, b in view.kernels], view.window_s)
