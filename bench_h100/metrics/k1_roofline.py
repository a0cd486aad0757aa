"""``k1_roofline``: percent of K1's roofline bound (the cell's frozen work
at the published peaks) over K1's device time in the traced window."""


def read(view):
    return view.roofline_share("k1")
