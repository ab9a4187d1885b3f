"""Device meshes, tensor-parallel sharding and the collectives between
shards, for one process that drives every device (counterpart of
`sgpt_tpu/parallel`)."""
from .collectives import (all_gather, all_reduce_max, all_reduce_sum, copy_rows_to_host,
                          gather_rows, rows_to_device, sum_grads, wait_rows)
from .mesh import Mesh, arrange_devices, make_mesh, placement
from .sharding import (RowShards, ShardedDecoder, data_spec, param_specs, shard_params,
                       unshard_params)

__all__ = ["Mesh", "make_mesh", "arrange_devices", "placement", "param_specs",
           "shard_params", "unshard_params", "data_spec", "ShardedDecoder", "RowShards",
           "all_reduce_sum", "all_reduce_max", "all_gather", "gather_rows", "rows_to_device",
           "copy_rows_to_host", "wait_rows", "sum_grads"]
