"""The PyTorch port's package boundary: no jax on import, the mirrored
config and RNG equal the JAX package's, and parameters carry across."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from graphaibench_tpu.nn import layers as jl
from graphaibench_tpu.ops import rng as jrng
from graphaibench_tpu_torch.nn import layers as tl
from graphaibench_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_leave_jax_out():
    """Importing every module of the port (and chip_smoke) in a fresh
    interpreter loads no jax module and nothing of the JAX package;
    conftest imports jax here, hence the subprocess."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graphaibench_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'graphaibench_tpu_torch.')]\n"
        "assert len(names) >= 19, names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'graphaibench_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_model_config_fields_and_defaults_match():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tl.ModelConfig) == spec(jl.ModelConfig)


@pytest.mark.parametrize("args,kw", [
    (("gcn", 2, 128, 128, 16), {"lr": 0.01}),
    (("gcn", 3, 32, 16, 4), {"subg_size": 100}),
    (("gat", 2, 8, 8, 3), {}),
    (("ggnn", 4, 8, 8, 3), {"use_l2norm": False}),
])
def test_make_config_matches(args, kw):
    t = tl.make_config(*args, **dict(kw))
    j = jl.make_config(*args, **dict(kw))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.gconv_dims == j.gconv_dims


@pytest.mark.parametrize("dims,seed", [((3, 3), 1), ((128, 16), 1),
                                       ((16, 1), 2), ((7, 5), 0)])
def test_glorot_reference_bit_equal(dims, seed):
    t = trng.glorot_reference(*dims, seed)
    j = jrng.glorot_reference(*dims, seed)
    assert t.dtype == j.dtype == np.float32
    assert np.array_equal(t.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("use_dense", [False, True])
def test_params_from_jax_equal_port_init(use_dense):
    cfg = jl.make_config("gcn", 2, 24, 16, 5, use_l2norm=use_dense)
    jparams = jax.tree.map(np.asarray, jl.init_params(cfg))
    carried = tl.params_from_jax(jparams, "cpu")
    own = tl.init_params(tl.make_config("gcn", 2, 24, 16, 5,
                                        use_l2norm=use_dense), device="cpu")
    names = [n for n, _ in own.named_parameters()]
    assert names == ["gconv.0.W_neigh", "gconv.1.W_neigh"] + (
        ["dense.W"] if use_dense else [])
    for (n1, a), (n2, b) in zip(carried.named_parameters(),
                                own.named_parameters()):
        assert n1 == n2
        assert torch.equal(a, b), n1


@pytest.mark.parametrize("arch", ["sage", "gat", "ggnn"])
def test_unported_archs_name_their_roadmap_item(arch):
    cfg = tl.make_config(arch, 2, 8, 8, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.init_params(cfg, device="cpu")
