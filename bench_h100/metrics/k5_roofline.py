"""``k5_roofline``: percent of K5's roofline bound (the cell's frozen work
at the published peaks) over the device time of K5's three kernels in the
traced window."""


def read(view):
    return view.roofline_share("k5")
