"""The sharded trainers: vertex partition, halo exchange over
``torch.distributed``, feature-dimension tensor parallelism, data-parallel
GraphSAINT and per-rank shard files, with the ranks' local ops on the
port's kernels.

Counterpart of ``graphaibench_tpu/parallel`` for its trainers (P14a and
P14b's trainer half); the distributed analytics (``dist_analytics.py``)
are still to be ported (ROADMAP, P14c).
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
