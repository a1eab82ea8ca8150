"""The parallel layer: a ``data x model`` mesh on ``torch.distributed`` and
the sharded train step (counterpart of ``continuousnormalizingflows_tpu.parallel``)."""

from .mesh import (
    data_sharding,
    host_local_batch,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_batch_arrays,
    shard_mlp_params,
    shard_train_step,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch_arrays",
    "shard_mlp_params",
    "shard_train_step",
    "host_local_batch",
    "initialize_distributed",
]
