"""``arg_roofline``: percent of the activation step's roofline bound (the
cell's frozen work at the published peaks: each input read once and each
output written once, 268 bytes a point at float32, which bind) over the
device time of the group ``arg`` in the traced window."""


def read(view):
    return view.roofline_share("arg")
