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
    """Importing every module of the port (``parallel/`` too) and
    chip_smoke in a fresh interpreter loads no jax module and nothing of
    the JAX package;
    conftest imports jax here, hence the subprocess."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graphaibench_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'graphaibench_tpu_torch.')]\n"
        "assert len(names) >= 64, names\n"
        "for new in ('nn.sampler', 'utils.timers', 'utils.checkpoint', 'entry', 'ops.ell_edge', 'ops._ell_launch',\n"
        "            'ops.ell_pull', 'analytics', 'analytics.verifiers', 'analytics.traversal', 'analytics.pr', 'analytics.cc',\n"
        "            'compress', 'compress.unary', 'compress.vbyte', 'compress.cgr', 'compress.hybrid', 'compress.cli',\n"
        "            'compress.cgr_device', 'ops.cgr_decode', 'analytics.tc_stream',\n"
        "            'compress.device_decode', 'ops.vbyte_decode', 'parallel', 'parallel.partition',\n"
        "            'parallel.multihost', 'parallel.halo', 'parallel.shard_ell', 'parallel.train',\n"
        "            'parallel.tp', 'parallel.dp_saint', 'parallel.shard_io', 'graph.partition',\n"
        "            'ops.first_fit', 'analytics.coloring', 'analytics.cf', 'analytics.mst',\n"
        "            'analytics.khop', 'analytics.embedding', 'analytics.ann', 'graph.labels',\n"
        "            'graph.converters', 'analytics.motif', 'analytics.fsm', 'analytics.community',\n"
        "            'analytics.linkpred', 'analytics.hac', 'analytics.assignment'):\n"
        "    assert 'graphaibench_tpu_torch.' + new in names, new\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from graphaibench_tpu_torch.graph.transforms import dense_adjacency, locality_order, relabel\n"
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
    """Every architecture initialises, and layer remat (P11), the last
    knob each refused, is ported: the remat forward under autograd equals
    JAX's ``cfg.remat`` forward (rate 0, COO strategy) within 1e-5."""
    from graphaibench_tpu.graph.generators import rmat as jrmat
    from graphaibench_tpu.ops import device_graph as jdg
    from graphaibench_tpu_torch.graph.generators import rmat as trmat
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    cfg = tl.make_config(arch, 2, 8, 8, 3, remat=True, spmm_impl="coo")
    params = tl.init_params(cfg, device="cpu")
    assert [n.split(".")[-1] for n, _ in params.gconv[0].named_parameters()
            ] == list(tl.LAYER_PARAMS[arch])
    jg, tg = jrmat(6, 4, seed=0), trmat(6, 4, seed=0)
    x = np.random.default_rng(0).standard_normal((tg.nv, 8)).astype(
        np.float32)
    w = np.random.default_rng(1).random(tg.ne).astype(np.float32)
    jcfg = jl.make_config(arch, 2, 8, 8, 3, remat=True, spmm_impl="coo")
    want = jl.apply_model(jcfg, jl.init_params(jcfg), jdg.to_device_graph(jg),
                          jax.numpy.asarray(w), jax.numpy.asarray(x),
                          train=True, key=jax.random.PRNGKey(0))
    got = tl.apply_model(cfg, params, to_device_graph(tg, device="cpu"),
                         torch.from_numpy(w), torch.from_numpy(x), train=True,
                         generator=torch.Generator().manual_seed(0))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,layers,dims", [
    ("sage", 2, (24, 16, 5)), ("gat", 2, (24, 16, 5)), ("gat", 3, (8, 8, 3)),
    ("ggnn", 1, (24, 16, 5)), ("ggnn", 1, (16, 16, 5))])
def test_params_from_jax_carry_every_arch(arch, layers, dims):
    """The JAX pytree's paths become the module's names, value for value,
    and the port's own init draws the same numbers."""
    jcfg = jl.make_config(arch, layers, *dims)
    jparams = jax.tree.map(np.asarray, jl.init_params(jcfg))
    carried = dict(tl.params_from_jax(jparams, "cpu").named_parameters())
    own = dict(tl.init_params(tl.make_config(arch, layers, *dims),
                              device="cpu").named_parameters())
    want = {f"gconv.{l}.{k}": v for l, layer in enumerate(jparams["gconv"])
            for k, v in layer.items()}
    if "dense" in jparams:
        want["dense.W"] = jparams["dense"]["W"]
    assert set(carried) == set(own) == set(want)
    for name, value in want.items():
        assert np.array_equal(carried[name].detach().numpy(), value), name
        assert torch.equal(carried[name], own[name]), name
    with pytest.raises(ValueError, match="not those"):
        tl.params_from_jax({"gconv": [{"W_neigh": value, "bogus": value}]},
                           "cpu")
