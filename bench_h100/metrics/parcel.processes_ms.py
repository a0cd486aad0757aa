"""``parcel.processes_ms``: host milliseconds a step in the parcel step's
process families (the spans ``parcel.activation``, ``parcel.deposition``,
``parcel.immersion``, ``parcel.homogeneous``,
``parcel.condensation_growth``, ``parcel.deposition_growth``; a family the
configuration disables has none): their total over the traced window per
step."""

from bench_h100.spans import per_step_ms

FAMILIES = ("parcel.activation", "parcel.deposition", "parcel.immersion",
            "parcel.homogeneous", "parcel.condensation_growth",
            "parcel.deposition_growth")


def read(view):
    return per_step_ms(view, names=FAMILIES)
