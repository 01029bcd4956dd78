"""The sharded full-batch trainer: vertex partition, halo exchange over
``torch.distributed``, and the ranks' local ops on the port's kernels.

Counterpart of ``graphaibench_tpu/parallel`` for its 1-D trainer (P14a);
the tensor-parallel trainer, data-parallel GraphSAINT, the shard files
and the distributed analytics are still to be ported (ROADMAP, P14b).
"""

from graphaibench_tpu_torch.parallel.partition import ShardedGraph, build_sharded_graph, pad_rows  # noqa: F401
from graphaibench_tpu_torch.parallel.halo import halo_exchange, make_sharded_spmm  # noqa: F401
from graphaibench_tpu_torch.parallel.multihost import initialize, launch  # noqa: F401
from graphaibench_tpu_torch.parallel.train import ShardedTrainer, make_sharded_trainer  # noqa: F401
