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
      GraphSAINT sampler), built with g++ at first use; numpy routes
      without a toolchain
graph CSR container, transforms, generators, dataset readers
ops   device graph (degree-bucketed ELL), the kernels (CUDA C++ in
      ``csrc/``: the ELL SpMM, the fused GAT attention's passes, the
      passes over per-edge values, the analytics' neighbour reduction)
      with their plain PyTorch versions, SpMM and attention autograd,
      segment ops, math
nn    layers of the four architectures, losses, the reference's
      optimizers, the GraphSAINT sampler, the training Model
analytics  the pull-mode solvers (BFS, SSSP, PageRank, CC) with their
      serial verifiers and ``run_benchmark``
utils stage timers, profiler capture, checkpoints
entry ``entry()``: the flagship model's forward function and arguments
cli   ``python -m graphaibench_tpu_torch.cli train <arch> <dataset> ...``
      and ``... cli analytics bfs|sssp|pr|cc <dataset> [source]``
"""

__version__ = "0.1.0"

from graphaibench_tpu_torch.graph.csr import CSRGraph  # noqa: F401
from graphaibench_tpu_torch.graph.generators import rmat  # noqa: F401
from graphaibench_tpu_torch.graph.io import GnnDataset  # noqa: F401
