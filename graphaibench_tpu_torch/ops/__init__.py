"""Device graph, the ELL SpMM kernel and its strategies, segment ops, the
fused GAT attention and its kernels, RNG and math.

The functions ``spmm`` and ``ell_spmm`` are not re-exported here: their
names are also those of the modules ``ops.spmm`` and ``ops.ell_spmm``, and
a re-export would hide the module (``from graphaibench_tpu_torch.ops
import ell_spmm`` must give the module, whose ``LAUNCHES`` count callers
read). Import them from their modules.
"""

from graphaibench_tpu_torch.ops.device_graph import (  # noqa: F401
    DeviceGraph,
    PackedEdgeW,
    pack_edge_values,
    to_device_graph,
)
from graphaibench_tpu_torch.ops.rng import glorot_reference, uniform_reference  # noqa: F401
