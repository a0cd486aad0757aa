"""``step.host_ms``: host milliseconds a step inside the program's step
entry, the spans ``step.*`` (``Column1MStep.forward``,
``ColumnP3Step.forward``, ``parcel_step``) that the program records while
the profiler records the window: their total over the window per step."""

from bench_h100.spans import per_step_ms


def read(view):
    return per_step_ms(view, prefix="step.")
