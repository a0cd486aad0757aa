"""Device-mesh parallelism (column data parallelism) over
``torch.distributed``; :mod:`.dryrun` drives the column steps over an
n-rank mesh."""

from .comms import (
    COLUMN_AXIS,
    column_mesh,
    column_sharding,
    initialize_distributed,
    is_dtensor,
    local_columns,
    replicated,
    shard_columns,
)
