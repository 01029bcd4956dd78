"""The sharded trainers and the distributed analytics: vertex partition,
halo exchange over ``torch.distributed``, feature-dimension tensor
parallelism, data-parallel GraphSAINT, per-rank shard files and the
analytics solvers over a rank's shard, with the ranks' local ops on the
port's kernels.

Counterpart of ``graphaibench_tpu/parallel``.
"""

from graphaibench_tpu_torch.parallel.partition import ShardedGraph, build_sharded_graph, pad_rows  # noqa: F401
from graphaibench_tpu_torch.parallel.halo import halo_exchange, make_sharded_spmm  # noqa: F401
from graphaibench_tpu_torch.parallel.multihost import hybrid_groups, initialize, launch  # noqa: F401
from graphaibench_tpu_torch.parallel.tp import MODEL_AXIS  # noqa: F401
from graphaibench_tpu_torch.parallel.train import (  # noqa: F401
    ShardedTrainer,
    make_sharded_trainer,
    make_tp_trainer,
)
from graphaibench_tpu_torch.parallel.dp_saint import train_sampled_dp  # noqa: F401
from graphaibench_tpu_torch.parallel.shard_io import (  # noqa: F401
    make_sharded_trainer_from_files,
    write_trainer_shards,
)
from graphaibench_tpu_torch.parallel.dist_analytics import (  # noqa: F401
    distributed_bc,
    distributed_bfs,
    distributed_cc,
    distributed_kcore,
    distributed_pagerank,
    distributed_sssp,
    distributed_triangle_count,
    distributed_triangle_count_2d,
    gather_own,
)
