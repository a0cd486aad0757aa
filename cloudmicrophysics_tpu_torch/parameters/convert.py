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
An aerosol distribution's modes (``ModeB`` or ``ModeKappa``) and a parcel's
aerosol species follow from their keys too; species whose fields have the
same names (the dusts) are told apart by their default values, and take
the tree's values whichever class is picked.

:func:`mlp_params_from_flax`, :func:`gp_params_from_numpy` and
:func:`trees_params_from_numpy` take the JAX package's fitted emulator
parameters (as numpy) into the port's ``models.emulator`` families.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.quadrature import Tabulated
from . import aerosol_species
from .aerosol import AerosolDistribution, ModeB, ModeKappa
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
           "column_state_2m_from_numpy", "column_state_p3_from_numpy",
           "parcel_state_from_numpy", "box_state_from_numpy",
           "p3_sandbox_state_from_numpy", "mlp_params_from_flax",
           "gp_params_from_numpy", "trees_params_from_numpy"]

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
    from ..models.parcel import ParcelParams, parcel_params

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
    elif cls is AerosolDistribution:
        return AerosolDistribution(modes=tuple(
            _by_fields((ModeB, ModeKappa), m) for m in tree["modes"]))
    elif cls in (ModeB, ModeKappa):
        return _by_fields((cls,), tree)
    elif cls is ParcelParams:
        options = {f.name: tree[f.name] for f in dataclasses.fields(cls)
                   if isinstance(f.default, str)}
        aerosol = tree["aerosol"]
        template = parcel_params(
            **options, aerosol=None if aerosol is None else _species(aerosol)())
    elif cls in _TEMPLATES:
        template = _TEMPLATES[cls]()
    else:
        template = cls()
    return _fill(template, tree)


def _by_fields(classes, tree: Mapping[str, Any]):
    """The first of ``classes`` whose field names are the tree's keys,
    built from the tree's values (tuples of floats kept as tuples)."""
    def value(v):
        if isinstance(v, (tuple, list, np.ndarray)):
            return tuple(float(x) for x in np.ravel(v))
        return float(v)

    for c in classes:
        names = [f.name for f in dataclasses.fields(c)]
        if set(names) == set(tree):
            return c(**{n: value(tree[n]) for n in names})
    raise ValueError(f"no class of {[c.__name__ for c in classes]} has the "
                     f"fields {sorted(tree)}")


def _species(tree: Mapping[str, Any]) -> type:
    """The aerosol species class with the tree's field names: the one whose
    defaults are the tree's values where there is one, else the first."""
    classes = [c for c in vars(aerosol_species).values()
               if dataclasses.is_dataclass(c) and isinstance(c, type)
               and {f.name for f in dataclasses.fields(c)} == set(tree)]
    if not classes:
        raise ValueError(f"no aerosol species has the fields {sorted(tree)}")
    exact = [c for c in classes
             if all(float(tree[f.name]) == f.default
                    for f in dataclasses.fields(c))]
    return (exact or classes)[0]


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


def _state_from_numpy(cls, arrays, device, dtype):
    return cls(*(
        torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in cls._fields))


def column_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: torch.device | str = "cuda",
                            dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnState` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnState

    return _state_from_numpy(ColumnState, arrays, device, dtype)


def column_state_2m_from_numpy(arrays: Mapping[str, np.ndarray],
                               device: torch.device | str = "cuda",
                               dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnState2M` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnState2M

    return _state_from_numpy(ColumnState2M, arrays, device, dtype)


def column_state_p3_from_numpy(arrays: Mapping[str, np.ndarray],
                               device: torch.device | str = "cuda",
                               dtype: torch.dtype | None = None):
    """A :class:`models.column.ColumnStateP3` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given)."""
    from ..models.column import ColumnStateP3

    return _state_from_numpy(ColumnStateP3, arrays, device, dtype)


def parcel_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: torch.device | str = "cuda",
                            dtype: torch.dtype | None = None):
    """A :class:`models.parcel.ParcelState` of tensors on ``device`` (the
    GPU unless ``device="cpu"`` is asked for) from a dict of numpy arrays
    keyed by field name (dtype kept unless given). An ensemble is a state
    whose fields have shape ``(N,)``."""
    from ..models.parcel import ParcelState

    return _state_from_numpy(ParcelState, arrays, device, dtype)


def box_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device: torch.device | str = "cuda",
                         dtype: torch.dtype | None = None):
    """A :class:`models.box.BoxState` of tensors on ``device`` (the GPU
    unless ``device="cpu"`` is asked for) from a dict of numpy arrays keyed
    by field name (dtype kept unless given)."""
    from ..models.box import BoxState

    return _state_from_numpy(BoxState, arrays, device, dtype)


def p3_sandbox_state_from_numpy(arrays: Mapping[str, np.ndarray],
                                device: torch.device | str = "cuda",
                                dtype: torch.dtype | None = None):
    """A :class:`models.p3_sandbox.P3SandboxState` of tensors on ``device``
    (the GPU unless ``device="cpu"`` is asked for) from a dict of numpy
    arrays keyed by field name (dtype kept unless given)."""
    from ..models.p3_sandbox import P3SandboxState

    return _state_from_numpy(P3SandboxState, arrays, device, dtype)


def mlp_params_from_flax(flax_params: Mapping[str, Any],
                         device: torch.device | str = "cuda"):
    """The :class:`models.emulator.ActivationMLP` parameter dict (float32
    tensors on ``device``, the GPU unless ``device="cpu"`` is asked for) of
    the JAX package's fitted flax parameters, ``{"params": {"Dense_i":
    {"kernel", "bias"}}}`` (the ``"params"`` level may be left out). flax
    keeps a kernel as ``(in, out)``, ``nn.Linear`` its weight as
    ``(out, in)``."""
    tree = flax_params.get("params", flax_params)
    out = {}
    for i in range(len(tree)):
        dense = tree[f"Dense_{i}"]
        out[f"layers.{i}.weight"] = torch.as_tensor(
            np.asarray(dense["kernel"], np.float32).T.copy(), device=device)
        out[f"layers.{i}.bias"] = torch.as_tensor(
            np.array(dense["bias"], np.float32), device=device)
    return out


def gp_params_from_numpy(params: Mapping[str, Any],
                         device: torch.device | str = "cuda"):
    """The :class:`models.emulator.GPRegressor` params dict (float32
    tensors on ``device``) from the JAX package's ``{X_train, alpha,
    y_mean, x_mean, x_std}``."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in params.items()}


def trees_params_from_numpy(params: Mapping[str, Any],
                            device: torch.device | str = "cuda"):
    """The :class:`models.emulator.BoostedTreesRegressor` params dict
    (int64 features, float32 thresholds, leaves and bias, on ``device``)
    from the JAX package's ``{features, thresholds, leaves, bias}``."""
    return {k: torch.as_tensor(
        np.array(v, np.int64 if k == "features" else np.float32),
        device=device) for k, v in params.items()}
