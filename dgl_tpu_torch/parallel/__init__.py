"""Multi-device parallelism over ``torch.distributed`` (counterpart of
``dgl_tpu/parallel/``): so far the dense-bitmask family, the sharded
bitmask SpMM (``bitspmd``) and GAT attention (``bitgat_spmd``) with the
collectives they need (``comm``) and the counterpart of the JAX
package's multi-device dry run (``dryrun``)."""
from .bitspmd import (
    BitShardedFormat,
    build_bit_sharded_format,
    build_bit_sharded_format_device,
    shard_format as shard_bit_format,
    pad_nodes as pad_bit_nodes,
    local_rows as local_bit_rows,
    bit_sharded_spmm,
    sharded_in_degrees as bit_sharded_in_degrees,
)
from .bitgat_spmd import bit_sharded_gat
from .comm import (
    init_group,
    all_gather_rows,
    reduce_scatter_rows,
    all_reduce_sum,
    run_ranks,
)
from .dryrun import dryrun_multichip
