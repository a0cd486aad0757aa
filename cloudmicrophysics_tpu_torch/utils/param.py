"""Parameter-struct machinery.

A parameter struct is a frozen dataclass whose float fields are plain
Python floats. Combined with a float32 tensor, a Python float does not
promote the result, so one struct serves float32 and float64 states alike.
:func:`static_field` marks a field that selects code (an option string, a
coefficient tuple) rather than holding a number; it changes no behaviour
here and exists so a reader sees the same field kinds as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import MISSING, field
from typing import Any, TypeVar

_T = TypeVar("_T")

_STATIC_KEY = "cmt_static"


def static_field(default: Any = MISSING, **kwargs: Any):
    """A dataclass field that selects code instead of holding a number."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_KEY] = True
    if default is MISSING:
        return field(metadata=metadata, **kwargs)
    return field(default=default, metadata=metadata, **kwargs)


def paramclass(cls: type[_T]) -> type[_T]:
    """Decorator: a frozen dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


def replace(obj: _T, **changes: Any) -> _T:
    """``dataclasses.replace`` for paramclasses."""
    return dataclasses.replace(obj, **changes)
