"""The comparison that decides ``correct``.

A cell (``drivers/<kind>.py``) hands over the program's answers of a step
and the plain reference's answers for the same input, each a ``(rows,
ncol, nlev)`` tensor, and names groups of rows, each compared as one
number (see :class:`GapSum`): ``state_off``, the share of the prognostic
fields' entries that depart from the reference by more than a tolerance in
units of each field's scale; ``column_off``, the largest such share within
one column; for P3 also ``loglambda_off``, the share of cells whose log
lambda departs from the reference's. A few entries that a re-rounded but
sound program moves across a branch (the melting point's switch, the end
of a fixed-trip root search) stay far below a share's limit; a step in a
lower precision, a step left out or a column gone wrong do not.

The reference runs over a sample of columns drawn from the seed (or all of
them), in blocks of columns, so that it fits beside the program's kept
states; the sums behind each gap run over every block.
"""

from __future__ import annotations

import math

import torch

# the precisions a configuration's reference may be computed in
DTYPES = {"float64": torch.float64, "float32": torch.float32}


class GapSum:
    """Running sums over blocks of columns and over checked steps, read out
    as one number per group of rows.

    Each group is ``(kind, rows)``; its tolerance comes from the workload's
    ``check`` spec. A ``gap`` group's number is the largest, over its rows,
    of the widest absolute difference between program and reference in
    units of the row's scale (its largest magnitude in the seeded state).
    A ``share`` group's number is the share of its entries where the
    program departs from the reference by more than the tolerance times
    the row's scale; a ``column`` group's is the largest such share within
    one column (every row of the group at every level), so that one column
    gone wrong shows however many columns are checked; an ``off`` group's
    is the share of its entries that depart by more than the tolerance
    itself. Equal answers agree, non-finite ones too; a non-finite answer
    where the reference's differs departs without bound.
    """

    def __init__(self, groups: dict, tolerance: dict, scale: torch.Tensor):
        self.groups = groups
        self.tolerance = tolerance
        self.scale = scale.to(torch.float64)
        self.gap = {}
        self.count = {name: [0, 0] for name in groups}

    def add(self, program: torch.Tensor, reference: torch.Tensor) -> None:
        p = program.to(torch.float64)
        r = reference.to(torch.float64)
        same = (p == r) | (torch.isnan(p) & torch.isnan(r))
        d = torch.where(same, 0.0, torch.nan_to_num((p - r).abs(),
                                                    nan=math.inf))
        scale = self.scale.to(d.device)[:, None, None]
        for name, (kind, rows) in self.groups.items():
            if kind == "gap":
                rel = d[rows] / scale[rows].clamp_min(1e-300)
                self.gap[name] = max(self.gap.get(name, 0.0),
                                     float(rel.max()))
                continue
            tol = self.tolerance[name]
            bound = tol if kind == "off" else tol * scale[rows]
            off = d[rows] > bound
            if kind == "column":
                share = off.sum(dim=(0, 2)).amax() / (off.shape[0]
                                                      * off.shape[2])
                self.count[name][0] = max(self.count[name][0], float(share))
                self.count[name][1] = 1
            else:
                self.count[name][0] += int(off.sum())
                self.count[name][1] += off.numel()

    def gaps(self) -> dict:
        """Group name -> its number (``inf`` for a non-finite answer)."""
        out = {}
        for name, (kind, _) in self.groups.items():
            if kind == "gap":
                out[name] = self.gap.get(name, 0.0)
            else:
                off, total = self.count[name]
                out[name] = off / total if total else 0.0
        return out


def sample_columns(ncol: int, count, seed: int) -> torch.Tensor:
    """``count`` distinct columns of ``ncol`` drawn from ``seed``, in
    order; every column when ``count`` is None or not below ``ncol``."""
    if count is None or count >= ncol:
        return torch.arange(ncol)
    g = torch.Generator()
    g.manual_seed(int(seed))
    return torch.randperm(ncol, generator=g)[:count].sort().values


def compare(acc: GapSum, cell, carry_in, carry_out, columns: torch.Tensor,
            block_columns: int, dtype: torch.dtype) -> None:
    """Add to ``acc`` the program's step ``carry_in -> carry_out`` against
    the reference computed in ``dtype`` on the same input, over
    ``columns``."""
    device = cell.device
    for lo in range(0, len(columns), block_columns):
        cols = columns[lo:lo + block_columns].to(device)
        with torch.no_grad():
            ref = cell.reference(carry_in, cols, dtype)
            acc.add(cell.answers(carry_out, cols), ref)
        del ref

