"""The port's per-rank shard files, on the CPU.

``write_trainer_shards`` in this process, then
``make_sharded_trainer_from_files`` in spawned gloo ranks beside the
in-memory trainer from the same weights: the 1-D trainer (2 ranks,
tests/test_parallel.py::test_trainer_from_shard_files_matches_in_memory's
graph and config) and the tensor-parallel one ((2 graph x 2 model),
test_tp_trainer_from_shard_files's). The first step's loss equals the
in-memory trainer's exactly, as do the masked accuracy and, under
balance="edge", ``eval_logits``, which come back in global vertex order
(the files keep ``perm``; JAX's drop it, and its file-built logits are
the first nv rows of the padded shard order, which a test here states).
Files of two writes mixed under one prefix are refused, by
``load_local_shards`` and by the ranks.

The ranks are spawned processes that import this module, so jax is
imported inside the tests only.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.graph.generators import rmat, uniform_random
from graphaibench_tpu_torch.nn.layers import ModelConfig, init_params
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
from graphaibench_tpu_torch.parallel import multihost
from graphaibench_tpu_torch.parallel import partition as tpart
from graphaibench_tpu_torch.parallel.shard_io import (
    load_local_shards,
    make_sharded_trainer_from_files,
    write_trainer_shards,
)
from graphaibench_tpu_torch.parallel.train import (
    make_sharded_trainer,
    make_tp_trainer,
)

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 240
# name -> (graph, arch, dims, G, M, balance)
CASES = {
    "1d": ("rmat9", "gcn", (16, 16), 2, 1, "vertex"),
    "1d_edge": ("rmat9", "gcn", (16, 16), 2, 1, "edge"),
    "1d_gat_edge": ("rmat9", "gat", (16, 16), 2, 1, "edge"),
    "tp": ("ur240", "gcn", (16, 8), 2, 2, "vertex"),
    "tp_edge": ("ur240", "sage", (16, 8), 2, 2, "edge"),
}


def _data(graph, f_in):
    g = rmat(9, 8, seed=0) if graph == "rmat9" else uniform_random(
        240, 700, seed=5)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, f_in)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    half = g.nv // 2
    return (g, feats, labels, mask, (0, g.nv, g.nv),
            {"val": ((half, g.nv, g.nv - half), mask)})


def _cfg(arch, dims):
    kw = dict(use_l2norm=True, use_dense=True) if arch == "gat" else {}
    return ModelConfig(arch=arch, num_layers=2, dim_init=dims[0],
                       dim_hid=dims[1], num_cls=4, lr=0.02, **kw)


def _host(name):
    graph, arch, dims, G, _M, balance = CASES[name]
    g, feats, labels, mask, tr, ev = _data(graph, dims[0])
    gp = prepare_graph(g, arch)
    sg = tpart.build_sharded_graph(gp, aggregation_weights(gp, arch), G,
                                   balance=balance)
    return _cfg(arch, dims), sg, (feats, labels, tr, mask), ev


def _rank_cases(rank, n, root):
    """Each case of ``n`` ranks: the in-memory and the file-built
    trainer's first loss, accuracy and eval_logits from the same initial
    weights; then the refusal of mixed files."""
    torch.set_num_threads(1)
    res = {}
    for name, (_g, _a, _d, G, M, _b) in CASES.items():
        if G * M != n:
            continue
        cfg, sg, args, ev = _host(name)
        if M == 1:
            t_mem = make_sharded_trainer(cfg, sg, *args, eval_ranges=ev)
        else:
            t_mem = make_tp_trainer(cfg, sg, *args, model_parallelism=M,
                                    eval_ranges=ev)
        t_file, cfg2 = make_sharded_trainer_from_files(
            os.path.join(root, name), model_parallelism=M)
        assert cfg2 == cfg
        out = {}
        for tag, t in (("mem", t_mem), ("file", t_file)):
            params = init_params(cfg, device="cpu")
            opt = OPTIMIZERS["adam"](params.parameters(), lr=cfg.lr)
            out[tag] = dict(logits=t.eval_logits(params).numpy(),
                            acc=t.eval_accuracy(params, "val"),
                            loss=t.train_step(params, opt).item())
        res[name] = out
    try:
        make_sharded_trainer_from_files(os.path.join(root, f"mixed{n}"),
                                        model_parallelism=n // 2)
        res["mixed"] = None
    except ValueError as e:
        res["mixed"] = str(e)
    return res


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Every case's files, and for each rank count a prefix whose shard 1
    comes from another write."""
    root = tmp_path_factory.mktemp("shards")
    for name in CASES:
        cfg, sg, args, ev = _host(name)
        write_trainer_shards(str(root / name), cfg, sg, *args,
                             eval_ranges=ev)
    for n, name in ((2, "1d"), (4, "tp")):
        cfg, sg, args, ev = _host(name)
        for p in (root / f"mixed{n}", root / "other"):
            write_trainer_shards(str(p), cfg, sg, *args, eval_ranges=ev)
        shutil.copy(root / "other-shard1.pkl", root / f"mixed{n}-shard1.pkl")
    return str(root)


@pytest.fixture(scope="module")
def ranks(root):
    return {n: multihost.launch(_rank_cases, n, root,
                                timeout_s=SPAWN_TIMEOUT_S) for n in (2, 4)}


@pytest.mark.parametrize("name", list(CASES))
def test_file_trainer_equals_in_memory(name, ranks):
    _g, _a, _d, G, M, balance = CASES[name]
    res = ranks[G * M]
    for r in range(G * M):
        mem, got = res[r][name]["mem"], res[r][name]["file"]
        assert got["loss"] == mem["loss"], (r, got["loss"], mem["loss"])
        assert got["acc"] == mem["acc"]
        np.testing.assert_array_equal(got["logits"], mem["logits"])
        np.testing.assert_array_equal(got["logits"], res[0][name]["file"]
                                      ["logits"])


def test_edge_balanced_logits_are_in_vertex_order(ranks):
    """Under balance="edge" the file-built logits are Model's, row for
    row: the files carry perm."""
    from graphaibench_tpu_torch.graph.io import GnnDataset
    from graphaibench_tpu_torch.nn import Model
    from graphaibench_tpu_torch.nn.layers import apply_model

    graph, arch, dims, G, M, _ = CASES["1d_edge"]
    g, feats, labels, mask, tr, _ = _data(graph, dims[0])
    _, sg, _, _ = _host("1d_edge")
    assert not np.array_equal(sg.perm, np.arange(g.nv))   # a real permutation
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    m = Model(_cfg(arch, dims), ds, device="cpu")
    with torch.no_grad():
        want = apply_model(m.cfg, m.params, m.full.device, m.full.edge_w_agg,
                           m.feats, trivial_w=True).numpy()
    np.testing.assert_allclose(ranks[G * M][0]["1d_edge"]["file"]["logits"],
                               want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_mixed_writes_are_refused(root, ranks, n):
    with pytest.raises(ValueError, match="another write"):
        load_local_shards(os.path.join(root, f"mixed{n}"), [0, 1])
    for r in range(n):
        assert "writes" in ranks[n][r]["mixed"]


def test_jax_file_trainer_drops_perm(tmp_path):
    """ROADMAP queue 3: JAX's file-built trainer under balance="edge"
    returns the first nv rows of its padded shard order, not its
    in-memory trainer's logits in vertex order (its files drop perm)."""
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.graph import generators as jgen
    from graphaibench_tpu.nn import layers as jl
    from graphaibench_tpu.nn.model import aggregation_weights as jaw
    from graphaibench_tpu.nn.model import prepare_graph as jprep
    from graphaibench_tpu.parallel import AXIS, build_sharded_graph
    from graphaibench_tpu.parallel import make_sharded_trainer as jmake
    from graphaibench_tpu.parallel.shard_io import (
        make_sharded_trainer_from_files as jfrom_files,
        write_trainer_shards as jwrite,
    )

    graph, arch, dims, G, _, _ = CASES["1d_edge"]
    _, feats, labels, mask, tr, ev = _data(graph, dims[0])
    c = _cfg(arch, dims)
    cfg = jl.ModelConfig(**{k: getattr(c, k) for k in (
        "arch", "num_layers", "dim_init", "dim_hid", "num_cls", "lr")})
    jg = jprep(jgen.rmat(9, 8, seed=0), arch)
    sg = build_sharded_graph(jg, jaw(jg, arch), G, balance="edge")
    mesh = Mesh(np.array(jax.devices()[:G]), (AXIS,))
    prefix = str(tmp_path / "j")
    jwrite(prefix, cfg, sg, feats, labels, tr, mask, eval_ranges=ev)
    params = jl.init_params(cfg)
    mem = np.asarray(jmake(mesh, cfg, sg, feats, labels, tr, mask)
                     .eval_logits(params))
    got = np.asarray(jfrom_files(mesh, prefix)[0].eval_logits(params))
    assert not np.allclose(got, mem)
    # what it returns: the first nv rows of the padded shard-order layout
    # (slot perm[v] holds vertex v; a slot of no vertex is padding)
    vertex_of = np.full(sg.padded_nv, -1)
    vertex_of[sg.perm] = np.arange(sg.nv)
    slots = np.flatnonzero(vertex_of[:sg.nv] >= 0)
    assert len(slots) < sg.nv   # some vertices' rows are not there at all
    np.testing.assert_allclose(got[slots], mem[vertex_of[slots]], rtol=1e-6,
                               atol=1e-6)
