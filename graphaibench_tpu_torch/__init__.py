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
native  C++ host kernels (CSR build, stable key sort, ELL packing), built
      with g++ at first use; numpy routes without a toolchain
graph CSR container, transforms, generators, dataset readers
ops   device graph (degree-bucketed ELL), the ELL SpMM kernel (CUDA C++
      in ``csrc/``) with its plain PyTorch version, SpMM autograd, math
nn    GCN layers, losses, the reference's Adam, the training Model
cli   ``python -m graphaibench_tpu_torch.cli train gcn <dataset> ...``
"""

__version__ = "0.1.0"

from graphaibench_tpu_torch.graph.csr import CSRGraph  # noqa: F401
from graphaibench_tpu_torch.graph.generators import rmat  # noqa: F401
from graphaibench_tpu_torch.graph.io import GnnDataset  # noqa: F401
