"""graphaibench_tpu_torch — the PyTorch/CUDA port of graphaibench_tpu.

The JAX package ``graphaibench_tpu`` is the reference; this package keeps
its module paths and names so each counterpart is easy to find, and runs
on an NVIDIA Hopper GPU (sm_90a). It imports ``torch`` and never ``jax``.

It imports nothing of ``graphaibench_tpu`` either: the host layer it
needs (CSR graphs, I/O, transforms, generators, the native C++ packers,
``ops/rng.py``, the host ELL packing, ``ModelConfig``) is its own copy
under the same names, and the tests hold every copy equal to the JAX
package's, bit for bit.

Subpackages
-----------
native  C++ host kernels (CSR build, stable key sort, ELL packing, the
      GraphSAINT sampler, the CGR codec), built with g++ at first use;
      numpy routes without a toolchain
graph CSR container, transforms, generators, dataset readers
ops   device graph (degree-bucketed ELL), the kernels (CUDA C++ in
      ``csrc/``: the ELL SpMM, the fused GAT attention's passes, the
      passes over per-edge values, the analytics' neighbour reduction,
      the triangle count, the h-index sweep, the CGR and byte-codec
      decodes, coloring's first fit) with their plain PyTorch versions,
      SpMM and attention autograd, segment ops, math
nn    layers of the four architectures, losses, the reference's
      optimizers, the GraphSAINT sampler, the training Model
analytics  the solvers (BFS, SSSP, PageRank, CC, triangles, k-core,
      betweenness; triangles and BFS also streamed off a CGR stream;
      coloring, collaborative filtering, Boruvka's spanning forest, k-hop
      sampling and random walks, DeepWalk and node2vec, kNN search) with
      their serial verifiers and ``run_benchmark``
compress  the compressed-graph codecs (CGR, StreamVByte, VarintGB,
      hybrid), their files, and CGR's decode on the device
parallel  the sharded full-batch trainer: vertex partition, process
      groups and a rank launcher, the halo exchange over
      ``torch.distributed``, each rank's tables on the kernels
utils stage timers, profiler capture, checkpoints
entry ``entry()``: the flagship model's forward function and arguments
cli   ``python -m graphaibench_tpu_torch.cli train <arch> <dataset> ...``
      (``GAB_SHARDS=<n|auto>``: the sharded trainer),
      ``... cli analytics <kernel> <dataset> [source]``, ``... cli info``
      and ``... cli compress compress|decompress|verify|info ...``
"""

__version__ = "0.1.0"

from graphaibench_tpu_torch.graph.csr import CSRGraph  # noqa: F401
from graphaibench_tpu_torch.graph.generators import rmat  # noqa: F401
from graphaibench_tpu_torch.graph.io import GnnDataset  # noqa: F401
