"""``k5.ms``: device milliseconds per step of K5, the 2M + P3 column
step's three kernels (shape solve, ice node pass, rates and
sedimentation), found by name in the traced window."""


def read(view):
    seconds = view.group_seconds("k5")
    return None if seconds is None else 1e3 * seconds / view.steps
