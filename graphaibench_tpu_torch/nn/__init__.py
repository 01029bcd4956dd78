from graphaibench_tpu_torch.nn.layers import (  # noqa: F401
    GcnParams,
    ModelConfig,
    apply_model,
    init_params,
    make_config,
    params_from_jax,
)
from graphaibench_tpu_torch.nn.losses import masked_sigmoid_loss, masked_softmax_loss  # noqa: F401
from graphaibench_tpu_torch.nn.model import GraphBundle, Model  # noqa: F401
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS, Adam  # noqa: F401
