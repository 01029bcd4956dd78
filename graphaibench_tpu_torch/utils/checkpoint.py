"""Training checkpoint/resume.

Counterpart of ``graphaibench_tpu/utils/checkpoint.py``: the reference
has no weight save/load, the JAX package added it, and the port keeps it.
One file per step, ``<path>/step_<n>.pt``, written with ``torch.save`` and
read back with ``weights_only=True`` (tensors and plain containers only)
onto the device the caller names.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save_checkpoint(path: str, state: Any, *, step: int = 0) -> str:
    """Save a nested dict/list of tensors under ``path`` (a directory).
    Returns the file's path. The file appears under its name only once it
    is complete."""
    os.makedirs(path, exist_ok=True)
    target = _file(path, step)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)
    return target


def restore_checkpoint(path: str, *, step: int = 0, device="cpu") -> Any:
    """What ``save_checkpoint`` wrote for ``step``, its tensors on
    ``device``."""
    return torch.load(_file(path, step), map_location=device,
                      weights_only=True)
