"""``k1.ms``: device milliseconds per step of K1, the 1M column kernel,
found by name in the traced window."""


def read(view):
    seconds = view.group_seconds("k1")
    return None if seconds is None else 1e3 * seconds / view.steps
