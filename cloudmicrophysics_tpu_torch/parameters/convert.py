"""Build the port's parameters and states from plain data.

:func:`from_tree` takes a parameter set as a nested dict of floats,
strings, tuples and numpy arrays (what ``dataclasses.asdict`` yields for
the JAX package's parameter structs, or for this package's own) and
returns the port's struct of the given class, so that both packages
compute with the same numbers. The classes of option-dependent fields
follow from the tree: ``ProcessParams1M`` from the 1M option selection,
the 2M rain velocity type (a field typed ``object``) from its keys, and,
for a 2M set with P3 ice, the quadrature order, the aspect-ratio option
and the slope law (``SlopePowerLaw`` or ``SlopeConstant``, again from the
keys). A ``Tabulated`` rule's node/weight tables are copied as float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.quadrature import Tabulated
from .common import Microphysics0MParams, microphysics_0m_params
from .m1 import Microphysics1MParams, microphysics_1m_params
from .m2 import Microphysics2MParams, microphysics_2m_params
from .terminal_velocity import (
    Blk1MVelType,
    TerminalVelocityParams,
    blk1m_vel_type,
    terminal_velocity_params,
)

__all__ = ["from_tree", "column_state_from_numpy",
           "column_state_2m_from_numpy", "column_state_p3_from_numpy"]

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
    elif cls is Microphysics2MParams:
        warm = tree["warm_rain"]
        ice = tree["ice"]
        template = microphysics_2m_params(
            is_limited=bool(warm["seifert_beheng"]["pdf_r"]["is_limited"]),
            with_ice=ice is not None,
            rain_velocity=_rain_velocity(warm["terminal_velocity"]),
            **({} if ice is None else _p3_options(ice)))
    elif cls in _TEMPLATES:
        template = _TEMPLATES[cls]()
    else:
        template = cls()
    return _fill(template, tree)


def _rain_velocity(tree: Mapping[str, Any]) -> str:
    """The ``rain_velocity`` option whose class has the tree's fields."""
    from .terminal_velocity import Chen2022VelTypeRain, SB2006VelType

    for name, vel_cls in (("sb2006", SB2006VelType),
                          ("chen2022", Chen2022VelTypeRain)):
        if set(tree) == {f.name for f in dataclasses.fields(vel_cls)}:
            return name
    raise ValueError(f"no rain velocity type has the fields {sorted(tree)}")


def _p3_options(tree: Mapping[str, Any]) -> dict:
    """The ``p3_ice_params`` options that build a template of the tree's
    shape: quadrature order, aspect-ratio option and slope law."""
    from .p3 import SlopeConstant, SlopePowerLaw

    slope = set(tree["scheme"]["slope"])
    laws = {"powerlaw": SlopePowerLaw, "constant": SlopeConstant}
    law = [k for k, c in laws.items()
           if slope == {f.name for f in dataclasses.fields(c)}]
    if not law:
        raise ValueError(f"no slope law has the fields {sorted(slope)}")
    return dict(quadrature_order=int(tree["quadrature_order"]),
                aspect_ratio=tree["scheme"]["aspect_ratio"],
                slope_law=law[0])


def _fill(obj, tree: Mapping[str, Any]):
    changes = {}
    for f in dataclasses.fields(obj):
        cur, new = getattr(obj, f.name), tree[f.name]
        if dataclasses.is_dataclass(cur):
            changes[f.name] = _fill(cur, new)
        elif isinstance(cur, Tabulated):
            y, w = new.nodes_weights()
            changes[f.name] = Tabulated(int(new.n),
                                        np.array(y, dtype=np.float64),
                                        np.array(w, dtype=np.float64))
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
                            device: torch.device | str = "cuda",
                            dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnState` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnState

    return ColumnState(*(
        torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in ColumnState._fields))


def column_state_2m_from_numpy(arrays: Mapping[str, np.ndarray],
                               device: torch.device | str = "cuda",
                               dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnState2M` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnState2M

    return ColumnState2M(*(
        torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in ColumnState2M._fields))


def column_state_p3_from_numpy(arrays: Mapping[str, np.ndarray],
                               device: torch.device | str = "cuda",
                               dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnStateP3` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnStateP3

    return ColumnStateP3(*(
        torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in ColumnStateP3._fields))
