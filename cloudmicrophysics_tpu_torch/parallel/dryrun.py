"""The multi-device dryrun: every column step over an n-rank ``columns``
mesh, one step each on tiny shapes, with its placements checked.

Port of ``__graft_entry__.dryrun_multichip``. On the CPU, n gloo ranks
stand in for the JAX package's n virtual devices:

    python -m cloudmicrophysics_tpu_torch.parallel.dryrun --ranks 2 --device cpu

On the cards, one rank per card under ``torchrun`` (NCCL):

    torchrun --nproc-per-node 4 -m cloudmicrophysics_tpu_torch.parallel.dryrun --ranks 4

Without ``torchrun`` the module spawns the ranks itself (:func:`spawn`):
on the cards NCCL when every rank has a card of its own, gloo when ranks
share one (NCCL refuses two ranks on one GPU). Rank 0 prints one JSON row.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from . import comms
from .comms import column_mesh, initialize_distributed, shard_columns

__all__ = ["check_sharded", "dryrun_multichip", "spawn"]

# How long a rank of :func:`spawn` waits on the others in a collective.
RANK_TIMEOUT = datetime.timedelta(minutes=5)


def check_sharded(what: str, tree) -> None:
    """Raise ``AssertionError`` unless every tensor of ``tree`` is a
    DTensor sharded along ``columns`` (placements ``(Shard(0),)`` on a mesh
    whose one dimension is named ``"columns"``)."""
    from ..perf import _leaves

    for t in _leaves(tree):
        if not comms.is_dtensor(t) or tuple(t.placements) != \
                comms.column_sharding(t.device_mesh) or \
                t.device_mesh.mesh_dim_names != (comms.COLUMN_AXIS,):
            raise AssertionError(f"{what}: an output is not sharded along "
                                 f"{comms.COLUMN_AXIS!r}")


def _close(what: str, out, ref, rtol: float, atol: float = 0.0) -> None:
    """This rank's shards of two DTensors agree within ``rtol``/``atol``."""
    np.testing.assert_allclose(out.to_local().cpu().numpy(),
                               ref.to_local().cpu().numpy(), rtol=rtol,
                               atol=atol, err_msg=what)


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> dict:
    """Step every column path once over an ``n_devices``-rank ``columns``
    mesh on ``8 * n_devices`` x 8 columns and check each output's
    placement, following ``__graft_entry__.dryrun_multichip``:

    * the 1M step through :class:`~..models.column.Column1MStep` on the
      repository's benchmark recipe (K2 on the card);
    * the 2M warm-rain step, eager and fused (K3), within rtol 2e-5 of
      each other, on the TPU benchmark's uniform state;
    * the 2M + P3 step at GL-8, cold and then warm-started; the same
      warm step in two column chunks per shard, within rtol 2e-5 of the
      unchunked one; and the fused step (K5), within its contract (fields
      rtol 3e-5 / atol 1e-10) of the eager one;
    * a timed sharded 1M step (:func:`..perf.measure`: CUDA events on the
      card, the host clock on the CPU) and an ``all_reduce`` checksum of
      its rain, which must be finite.

    Every rank of the group calls it; with no group up and
    ``n_devices == 1`` it runs on a one-rank group of its own. Returns the
    timed step's row (as ``benchmarks/scaling.py:measure_rung``'s).
    """
    from ..models.bench_states import (
        device_state,
        uniform_state_2m,
        uniform_state_p3,
    )
    from ..models.column import Column1MStep, step_column_2m, step_column_p3
    from ..parameters import (
        ThermodynamicsParameters,
        microphysics_1m_params,
        microphysics_2m_params,
        terminal_velocity_params,
    )
    from ..perf import measure

    world = dist.get_world_size() if comms._distributed_is_initialized() \
        else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a group of "
                         f"{n_devices} ranks, found {world}")
    mesh = column_mesh(device=device)
    dev = comms._mesh_device(mesh)
    ncol, nlev = 8 * n_devices, 8
    tps = ThermodynamicsParameters()

    model = Column1MStep(microphysics_1m_params(), tps,
                         terminal_velocity_params(), 1.0, 100.0, device=dev)
    state = shard_columns(device_state(ncol, nlev, dev), mesh)
    check_sharded("1M step", model(state))

    mp2 = microphysics_2m_params()
    st2 = shard_columns(uniform_state_2m(ncol, nlev, dev), mesh)
    out2 = step_column_2m(st2, mp2, tps, 1.0, 100.0)
    out2f = step_column_2m(st2, mp2, tps, 1.0, 100.0, impl="fused")
    check_sharded("2M step", out2)
    check_sharded("2M fused step", out2f)
    _close("2M fused vs eager q_rai", out2f.q_rai, out2.q_rai, rtol=2e-5)

    # the GL-8 production fast setting (quadrature-ladder verified)
    mp3 = microphysics_2m_params(with_ice=True, quadrature_order=8)
    st3 = shard_columns(uniform_state_p3(ncol, nlev, dev), mesh)
    out3, loglam = step_column_p3(st3, mp3, tps, 1.0, 100.0)
    out3b, _ = step_column_p3(out3, mp3, tps, 1.0, 100.0, loglam)
    check_sharded("P3 cold step", (out3, loglam))
    check_sharded("P3 warm step", out3b)
    # chunking per shard: the chunk loop never spans ranks
    out3c, _ = step_column_p3(out3, mp3, tps, 1.0, 100.0, loglam,
                              col_chunks=2)
    check_sharded("P3 chunked step", out3c)
    _close("P3 chunked vs unchunked q_ice", out3c.q_ice, out3b.q_ice,
           rtol=2e-5)
    out3f, loglam_f = step_column_p3(out3, mp3, tps, 1.0, 100.0, loglam,
                                     impl="fused")
    check_sharded("P3 fused step", (out3f, loglam_f))
    for name, a, b in zip(out3b._fields, out3f, out3b):
        _close(f"P3 fused vs eager {name}", a, b, rtol=3e-5, atol=1e-10)

    m = measure(lambda s, k: model(s), state, n_iter=1, reps=1)
    check_sharded("timed 1M step", m.last)
    checksum = m.last.q_rai.to_local().double().sum().reshape(1)
    on = "cuda" if dist.get_backend() == "nccl" else "cpu"
    checksum = checksum.to(on)
    dist.all_reduce(checksum)
    checksum = float(checksum[0])
    if not np.isfinite(checksum):
        raise AssertionError(f"non-finite checksum {checksum}")
    return {
        "kernel": "1m",
        "devices": n_devices,
        "ncol": ncol,
        "nlev": nlev,
        "steps": 1,
        "seconds_per_step": m.best_s,
        "grid_points_per_s": ncol * nlev / m.best_s,
        "checksum": checksum,
        "backend": dist.get_backend(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def _rank(rank: int, n_ranks: int, device: str, store: str, fn: Callable,
          args: tuple) -> None:
    backend = "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.init()   # PyTorch's own error without a card
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if n_ranks <= cards:
            backend = "nccl"
    initialize_distributed(device, backend=backend,
                           init_method=f"file://{store}", rank=rank,
                           world_size=n_ranks, timeout=RANK_TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, device: torch.device | str = "cuda",
          args: tuple = ()) -> None:
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined into one
    process group (a ``FileStore`` in a temporary directory), and wait for
    them; a rank's failure raises here. On the cards rank r works on card
    ``r % device_count`` over NCCL when every rank has a card of its own,
    and over gloo when ranks share a card; on the CPU over gloo. ``fn``
    must be importable (a module-level function)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank, args=(n_ranks, str(device), os.path.join(tmp, "store"),
                         fn, args),
            nprocs=n_ranks, join=True)


def _dryrun_rank(n_ranks: int, device: str) -> None:
    row = dryrun_multichip(n_ranks, device)
    if dist.get_rank() == 0:
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True,
                    help="ranks of the columns mesh")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks step (default: the cards)")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:     # under torchrun: this process is one rank
        initialize_distributed(args.device)
        try:
            _dryrun_rank(args.ranks, args.device)
        finally:
            dist.destroy_process_group()
    else:
        spawn(_dryrun_rank, args.ranks, args.device,
              (args.ranks, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
