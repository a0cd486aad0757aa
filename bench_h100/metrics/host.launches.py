"""``host.launches``: device kernels per step over the traced window, by
``torch.profiler`` (memory copies and sets not counted)."""


def read(view):
    if not view.kernels or not view.steps:
        return None
    return len(view.kernels) / view.steps
