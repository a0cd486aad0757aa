"""Build the port's parameters and states from plain data.

:func:`from_tree` takes a parameter set as a nested dict of floats,
strings, tuples and numpy arrays (what ``dataclasses.asdict`` yields for
the JAX package's parameter structs, or for this package's own) and
returns the port's struct of the given class, so that both packages
compute with the same numbers. The classes of option-dependent fields
(``ProcessParams1M``) follow from the option selection in the tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .common import Microphysics0MParams, microphysics_0m_params
from .m1 import Microphysics1MParams, microphysics_1m_params
from .terminal_velocity import (
    Blk1MVelType,
    TerminalVelocityParams,
    blk1m_vel_type,
    terminal_velocity_params,
)

__all__ = ["from_tree", "column_state_from_numpy"]

# Factories of the classes whose nested fields have no defaults; any other
# class is built with ``cls()``. The default instance is the template whose
# nested classes the tree's values are poured into.
_TEMPLATES = {
    TerminalVelocityParams: terminal_velocity_params,
    Blk1MVelType: blk1m_vel_type,
    Microphysics0MParams: microphysics_0m_params,
}


def from_tree(cls: type, tree: Mapping[str, Any]):
    """The port's ``cls`` with every field taken from ``tree``."""
    if cls is Microphysics1MParams:
        template = microphysics_1m_params(**tree["processes"])
    elif cls in _TEMPLATES:
        template = _TEMPLATES[cls]()
    else:
        template = cls()
    return _fill(template, tree)


def _fill(obj, tree: Mapping[str, Any]):
    changes = {}
    for f in dataclasses.fields(obj):
        cur, new = getattr(obj, f.name), tree[f.name]
        if dataclasses.is_dataclass(cur):
            changes[f.name] = _fill(cur, new)
        elif cur is None or isinstance(cur, str):
            if new != cur:
                raise ValueError(
                    f"{type(obj).__name__}.{f.name}: {new!r} does not match "
                    f"the option selection ({cur!r})")
            changes[f.name] = cur
        elif isinstance(cur, tuple):
            changes[f.name] = tuple(float(v) for v in np.asarray(new).ravel())
        elif isinstance(cur, bool):
            changes[f.name] = bool(new)
        elif isinstance(cur, int):
            changes[f.name] = int(new)
        else:
            changes[f.name] = float(new)
    return dataclasses.replace(obj, **changes)


def column_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: torch.device | str = "cpu",
                            dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnState` of tensors on ``device`` from a
    dict of numpy arrays keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnState

    return ColumnState(*(
        torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in ColumnState._fields))
