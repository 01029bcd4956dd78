"""Deterministic RNG reproducing the reference's weight initialization.

Mirror of ``graphaibench_tpu/ops/rng.py`` (pure numpy). It is mirrored,
not imported, because importing any ``graphaibench_tpu.ops`` module runs
``graphaibench_tpu/ops/__init__.py``, which imports jax. A test holds the
two bit-equal.

The reference initializes Glorot weights with
``std::default_random_engine(seed)`` + ``std::uniform_real_distribution
<float>(-r, r)`` (math_functions.cpp:11-18), with fixed seeds per tensor
(seed 1 for W_neigh, 2 for W_self — graph_conv_layer.cpp:4-51).

libstdc++'s default_random_engine is minstd_rand0:
    x_{n+1} = 16807 * x_n mod 2147483647,   x_0 = seed (or 1 if seed==0)
and uniform_real_distribution<float> maps one draw through
``__generate_canonical<float, 24>``: float(x - 1) / float(2147483646)
(both conversions in float32), then val = ret * (b - a) + a in float32.
"""

from __future__ import annotations

import numpy as np

_MOD = 2147483647  # 2^31 - 1
_MULT = 16807


def minstd0_stream(seed: int, n: int) -> np.ndarray:
    """First n raw draws of minstd_rand0 (values in [1, 2^31-2])."""
    out = np.empty(n, dtype=np.int64)
    x = seed % _MOD
    if x == 0:
        x = 1
    for i in range(n):
        x = (x * _MULT) % _MOD
        out[i] = x
    return out


def uniform_reference(seed: int, n: int, a: float, b: float) -> np.ndarray:
    """n float32 variates of uniform_real_distribution<float>(a, b) drawn
    from default_random_engine(seed), bit-exact with libstdc++."""
    raw = minstd0_stream(seed, n)
    ret = (raw - 1).astype(np.float32) / np.float32(2147483646)
    ret = np.minimum(ret, np.nextafter(np.float32(1.0), np.float32(0.0)))
    return (ret * np.float32(b - a) + np.float32(a)).astype(np.float32)


def glorot_reference(dim_x: int, dim_y: int, seed: int) -> np.ndarray:
    """init_glorot (math_functions.cpp:11-18): uniform(-r, r) with
    r = sqrt(6/(dim_x+dim_y)), filled row-major."""
    r = float(np.sqrt(6.0 / (dim_x + dim_y)))
    return uniform_reference(seed, dim_x * dim_y, -r, r).reshape(dim_x, dim_y)
