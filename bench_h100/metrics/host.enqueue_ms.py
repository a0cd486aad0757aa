"""``host.enqueue_ms``: host milliseconds to enqueue one step (the call of
the step module's ``forward``, from the cell's call to its return), the
mean over every step of the traced window."""


def read(view):
    if not view.enqueue_s:
        return None
    return 1e3 * sum(view.enqueue_s) / len(view.enqueue_s)
