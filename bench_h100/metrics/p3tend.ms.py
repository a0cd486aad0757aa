"""``p3tend.ms``: device milliseconds per step of the kernels a P3
tendency call launches (the tendency build of column_p3.cu: the bounds
kernel, K5b's node pass and the rates kernel), found by name in the traced
window; the host's shape solve, K5a, is not among them."""


def read(view):
    seconds = view.group_seconds("p3tend")
    return None if seconds is None else 1e3 * seconds / view.steps
