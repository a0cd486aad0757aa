"""``p3tend_roofline``: percent of the P3 tendency kernels' roofline bound
(the cell's frozen work at the published peaks) over their device time in
the traced window."""


def read(view):
    return view.roofline_share("p3tend")
