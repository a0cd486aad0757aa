"""Communication and sharding layer: column data parallelism over a
``torch.distributed`` device mesh.

Port of ``cloudmicrophysics_tpu/parallel/comms.py``. Microphysics is local
to a vertical column, so the only axis worth sharding is the horizontal
``columns`` axis: pure data parallelism with no communication in the step
(sedimentation is a stencil within a column). The JAX package's
``jax.sharding.Mesh`` becomes a one-dimensional
:class:`~torch.distributed.device_mesh.DeviceMesh` named ``"columns"``,
its ``NamedSharding(mesh, P("columns"))`` the placements ``(Shard(0),)``,
and ``jax.shard_map`` with ``in_specs=out_specs=P("columns")``
:func:`local_columns`, which runs a function on each rank's shard.

A rank steps its own shard on its own device: under ``torchrun`` each
rank sets its device (:func:`initialize_distributed` does) before it
builds a state. The column entry points of ``models/column.py`` take a
state whose fields are column-sharded DTensors and step it through
:func:`local_columns`, so the kernels only ever see a rank's local
tensors.

PyTorch's DTensor module is imported where a mesh or a DTensor is made,
never when this module is imported: the package's plain users do not pay
for it.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "COLUMN_AXIS",
    "column_mesh",
    "column_sharding",
    "initialize_distributed",
    "is_dtensor",
    "local_columns",
    "replicated",
    "shard_columns",
]

COLUMN_AXIS = "columns"

# The variables a launcher (torchrun) sets; a bare call with none of them
# set is a single process on a single host.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _distributed_is_initialized() -> bool:
    """True iff a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def _backend(device) -> str:
    """NCCL for the card, gloo when ``device`` is the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def initialize_distributed(device: torch.device | str = "cuda",
                           **kwargs) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    Call once at program start. Idempotent: a call with a group up is a
    no-op. A bare call with no launcher environment (none of ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``) is a no-op, so a program can call it
    unconditionally on a single host; under ``torchrun`` it joins the
    group from the environment and then sets the CUDA device to
    ``LOCAL_RANK``. ``kwargs`` go to ``init_process_group`` (``backend``,
    ``init_method``, ``store``, ``world_size``, ``rank``, ...); the backend
    is NCCL unless ``device="cpu"``, which selects gloo. Nothing is
    swallowed: a configuration that fails raises, and without a card the
    default fails with PyTorch's own error. A caller that passes its own
    ``rank`` sets its CUDA device itself.
    """
    if _distributed_is_initialized():
        return
    if not kwargs and not any(v in os.environ for v in _LAUNCHER_ENV):
        return
    kwargs.setdefault("backend", _backend(device))
    dist.init_process_group(**kwargs)
    if torch.device(device).type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))


def column_mesh(devices: Optional[Sequence[int]] = None,
                device: torch.device | str = "cuda"):
    """A 1-D ``DeviceMesh`` along ``"columns"`` over every rank of the
    group (or the ranks ``devices``), of the device type of ``device``:
    the card unless ``device="cpu"``.

    With no group up it first makes a one-rank group (a ``HashStore``,
    world size 1; NCCL, or gloo for the CPU), so single-process code runs
    as the JAX package's one-device mesh does. Without a card the default
    fails with PyTorch's own error.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not _distributed_is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    if devices is None:
        devices = range(dist.get_world_size())
    return DeviceMesh(torch.device(device).type, list(devices),
                      mesh_dim_names=(COLUMN_AXIS,))


def column_sharding(mesh) -> tuple:
    """The placements that shard the leading (column) axis across
    ``mesh``: ``(Shard(0),)``."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh) -> tuple:
    """The placements of a tensor every rank holds whole (scalars,
    parameters): ``(Replicate(),)``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``. Without PyTorch's DTensor module
    imported no tensor can be one, and nothing is imported to find out."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_columns(tree, mesh):
    """Every tensor leaf of ``tree`` (a state ``NamedTuple``, a tuple,
    list or dict of tensors) as a ``DTensor`` sharded along its leading
    axis over ``mesh``: this rank keeps its slice of the leading axis, on
    its device. No collective runs; every rank passes the same global
    tensors, as every process passes the same global arrays to the JAX
    package's ``device_put``. Raises ``ValueError`` when the mesh's size
    does not divide a leading axis.

    A packed ``(7, ncol, nlev)`` state has its columns on dim 1, so it is
    not sharded with this: shard the field ``NamedTuple`` and pack each
    rank's shard.
    """
    from torch.distributed.tensor import DTensor

    from ..perf import _map

    placements = column_sharding(mesh)
    n, rank = mesh.size(), mesh.get_local_rank()
    target = _mesh_device(mesh)

    def shard(t):
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(
                f"shard_columns: {n} ranks do not divide the leading axis "
                f"of a tensor of shape {tuple(t.shape)}")
        local = t.chunk(n)[rank].to(target).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False)

    return _map(shard, tree)


def local_columns(fn: Callable, mesh) -> Callable:
    """``fn`` run on each rank's shard: the counterpart of ``jax.shard_map``
    with ``in_specs=out_specs=P("columns")``.

    Every tensor of the arguments must be a ``DTensor`` sharded along its
    leading axis over ``mesh`` (:func:`shard_columns`), or ``ValueError``
    is raised; it is unwrapped to its local shard (``to_local``), ``fn``
    runs on the shards, and every tensor of the result is wrapped back as a
    ``DTensor`` with the same placements (``from_local``, unchecked). No
    collective runs: a column step is local in its columns.
    """
    from torch.distributed.tensor import DTensor

    from ..perf import _map

    placements = column_sharding(mesh)

    def local(t):
        if not is_dtensor(t) or tuple(t.placements) != placements or (
                t.device_mesh is not mesh and t.device_mesh != mesh):
            raise ValueError(
                "local_columns: every tensor argument must be a DTensor "
                f"sharded along {COLUMN_AXIS!r} on this mesh "
                "(shard_columns)")
        return t.to_local()

    @functools.wraps(fn)
    def wrapped(*args):
        out = fn(*_map(local, args))
        return _map(lambda t: DTensor.from_local(t, mesh, placements,
                                                 run_check=False), out)

    return wrapped
