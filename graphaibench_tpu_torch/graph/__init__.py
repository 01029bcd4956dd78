"""Host graph layer of the port: CSR container, transforms, generators, I/O."""

from graphaibench_tpu_torch.graph import transforms  # noqa: F401
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges  # noqa: F401
from graphaibench_tpu_torch.graph.io import (  # noqa: F401
    GnnDataset,
    load_gnn_dataset,
    load_gnn_dataset_csgr,
    load_graph,
    read_meta,
    save_graph,
)
