"""``arg.ms``: device milliseconds per step of the group ``arg``, found by
name in the traced window: every torch eager elementwise kernel of the
activation step (``vectorized_elementwise_kernel``,
``unrolled_elementwise_kernel``, ``elementwise_kernel``). That holds
``N_activated_per_mode``'s and ``M_activated_per_mode``'s kernels and the
host update's six (three adds summing the modes' numbers, the cloudy test,
the maximum and the select)."""


def read(view):
    seconds = view.group_seconds("arg")
    return None if seconds is None else 1e3 * seconds / view.steps
