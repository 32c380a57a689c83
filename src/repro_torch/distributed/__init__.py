from repro_torch.distributed.collectives import compressed_psum, make_compressed_grad_allreduce
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    set_sharding_context,
    shard_activation,
)

__all__ = [
    "param_shardings", "batch_shardings", "cache_shardings",
    "set_sharding_context", "shard_activation",
    "compressed_psum", "make_compressed_grad_allreduce",
]
