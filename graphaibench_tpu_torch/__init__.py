"""graphaibench_tpu_torch — the PyTorch/CUDA port of graphaibench_tpu.

The JAX package ``graphaibench_tpu`` is the reference; this package keeps
its module paths and names so each counterpart is easy to find, and runs
on an NVIDIA Hopper GPU (sm_90a). It imports ``torch`` and never ``jax``.

The jax-free host layer (CSR graphs, I/O, transforms, generators and the
native C++ packers) is imported from ``graphaibench_tpu.graph`` and
``graphaibench_tpu.native`` rather than copied. ``graphaibench_tpu.ops``
and ``graphaibench_tpu.nn`` import jax, so the pieces of them the port
needs (``ops/rng.py``, the host ELL packing, ``ModelConfig``) are
mirrored here instead.

Subpackages
-----------
ops   device graph (degree-bucketed ELL), the ELL SpMM kernel (CUDA C++
      in ``csrc/``) with its plain PyTorch version, SpMM autograd, math
nn    GCN layers, losses, the reference's Adam, the training Model
cli   ``python -m graphaibench_tpu_torch.cli train gcn <dataset> ...``
"""

__version__ = "0.1.0"

from graphaibench_tpu.graph.csr import CSRGraph  # noqa: F401
from graphaibench_tpu.graph.generators import rmat  # noqa: F401
from graphaibench_tpu.graph.io import GnnDataset  # noqa: F401
