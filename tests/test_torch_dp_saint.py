"""The port's data-parallel GraphSAINT against its serial definition and
against the JAX package's, on the CPU.

4 gloo ranks, GCN and GAT (hidden 8), subgraphs of 200 vertices of an
rmat(11, 8) training graph (tests/test_dp_saint.py's recipe, on a
synthetic graph): one step of ``train_sampled_dp`` equals the serial
mean-gradient step computed in one process from the same four seeds
(parameters, the averaged gradients and Adam's state within rtol 2e-5,
atol 2e-6), and JAX's ``train_sampled_dp`` on a 4-device CPU mesh within
the same tolerance; after 3 steps every rank holds the same parameters,
bit for bit. Then the CLI's ``GAB_DP=2`` route, and no fallback to the
CPU without a card.

The ranks are spawned processes that import this module, so jax is
imported inside the tests only. One spawn runs every case.
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.graph.io import GnnDataset
from graphaibench_tpu_torch.nn import Model
from graphaibench_tpu_torch.nn.layers import ModelConfig, leaves_in_param_order
from graphaibench_tpu_torch.parallel import multihost, train_sampled_dp

from test_torch_sharded import _cli, dataset  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 240
RANKS, SUBG, SEED, STEPS = 4, 200, 7, 3
ARCHS = ("gcn", "gat")
TOL = dict(rtol=2e-5, atol=2e-6)


def _arrays():
    """rmat(11, 8) with 16 features and 4 classes, from numpy seeds; the
    first half trains."""
    g = rmat(11, 8, seed=2)
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((g.nv, 16)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    ranges = {"train": (0, 1024, 1024), "val": (1024, 1536, 512),
              "test": (1536, 2048, 512)}
    masks = {}
    for name, (b, e, _) in ranges.items():
        masks[name] = np.zeros(g.nv, np.uint8)
        masks[name][b:e] = 1
    return g, feats, labels, ranges, masks


def _dataset(cls, g):
    _, feats, labels, ranges, masks = _arrays()
    return cls(graph=g, feats=feats, labels=labels,
               train_mask=masks["train"], val_mask=masks["val"],
               test_mask=masks["test"], num_classes=4,
               train_range=ranges["train"], val_range=ranges["val"],
               test_range=ranges["test"])


def _cfg(arch):
    return ModelConfig(arch=arch, num_layers=2, dim_init=16, dim_hid=8,
                       num_cls=4, lr=0.02)


def _model(arch):
    return Model(_cfg(arch), _dataset(GnnDataset, _arrays()[0]),
                 device="cpu")


def _state(model) -> dict:
    """Parameters, their gradients and Adam's buffers, as numpy."""
    st = model.opt.state_dict()
    ps = list(model.params.parameters())
    return {"params": [p.detach().numpy().copy() for p in ps],
            "grads": [p.grad.numpy().copy() for p in ps],
            "m": [t.numpy().copy() for t in st["m"]],
            "v": [t.numpy().copy() for t in st["v"]]}


def _rank_cases(rank, n):
    torch.set_num_threads(1)
    res = {}
    for arch in ARCHS:
        model = _model(arch)
        train_sampled_dp(model, 1, SUBG, seed=SEED, verbose=False)
        one = _state(model)
        # steps 1 and 2: the seeds train_sampled_dp(..., STEPS) would take
        log = train_sampled_dp(model, STEPS - 1, SUBG, seed=SEED + n,
                               verbose=False)
        res[arch] = dict(one=one, log=log,
                         params=[p.detach().numpy().copy()
                                 for p in model.params.parameters()])
    return res


@pytest.fixture
def jax_native(tmp_path_factory, monkeypatch):
    """test_torch_sampler's fixture, imported here only when a test asks
    for it: the spawned ranks import this module and no jax."""
    from test_torch_sampler import load_jax_native

    return load_jax_native(tmp_path_factory, monkeypatch)


@pytest.fixture(scope="module")
def ranks():
    return multihost.launch(_rank_cases, RANKS, timeout_s=SPAWN_TIMEOUT_S)


def _serial_step(arch) -> dict:
    """One step's expected result without the ranks: the RANKS subgraphs
    of seeds SEED + r, their gradients averaged, one Adam update."""
    model = _model(arch)
    prepare, e_pad = model._subgraph_source(SUBG)
    grads = []
    for r in range(RANKS):
        model._sampled_backward(prepare(SEED + r, e_pad))
        grads.append([p.grad.clone() for p in model.params.parameters()])
    for i, p in enumerate(model.params.parameters()):
        p.grad = sum((g[i] for g in grads[1:]), grads[0][i]) / RANKS
    model.opt.step()
    return _state(model)


def _jax_step(arch) -> dict:
    """JAX's train_sampled_dp, one step on a 4-device mesh."""
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.graph import generators as jgen
    from graphaibench_tpu.graph.io import GnnDataset as JDataset
    from graphaibench_tpu.nn import Model as JModel
    from graphaibench_tpu.nn import layers as jl
    from graphaibench_tpu.parallel.dp_saint import DATA_AXIS
    from graphaibench_tpu.parallel.dp_saint import train_sampled_dp as jdp

    c = _cfg(arch)
    cfg = jl.ModelConfig(**{k: getattr(c, k) for k in (
        "arch", "num_layers", "dim_init", "dim_hid", "num_cls", "lr")})
    model = JModel(cfg, _dataset(JDataset, jgen.rmat(11, 8, seed=2)))
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), (DATA_AXIS,))
    jdp(model, 1, SUBG, mesh=mesh, seed=SEED, verbose=False)
    leaves = leaves_in_param_order
    return {"params": [np.asarray(a) for a in leaves(model.params)],
            "m": [np.asarray(a) for a in leaves(model.opt_state.m)],
            "v": [np.asarray(a) for a in leaves(model.opt_state.v)]}


def _close(got: dict, want: dict, what: str) -> None:
    for key in want:
        for l, (a, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(a, w, **TOL,
                                       err_msg=f"{what} {key} leaf {l}")


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_equals_serial_mean_gradient(arch, ranks):
    _close(ranks[0][arch]["one"], _serial_step(arch), "serial")


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_jax(arch, ranks, jax_native):
    _close(ranks[0][arch]["one"], _jax_step(arch), "jax")


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_ranks_stay_bit_equal(arch, ranks):
    ours = ranks[0][arch]
    assert len(ours["log"]) == STEPS - 1
    for r in range(1, RANKS):
        theirs = ranks[r][arch]
        assert [l[:2] for l in theirs["log"]] == [l[:2] for l in ours["log"]]
        for key in ("params", "grads", "m", "v"):
            for a, b in zip(theirs["one"][key], ours["one"][key]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(theirs["params"], ours["params"]):
            np.testing.assert_array_equal(a, b)
    # the steps moved the parameters
    assert any(not np.array_equal(a, b) for a, b in
               zip(ours["params"], ours["one"]["params"]))


# ---- the CLI ------------------------------------------------------------

ARGV = ("4", "0", "softmax", "16", "0", "0", "0.02", "2", "256", "2")


def _check_dp_lines(r) -> None:
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "sharded trainer" not in out
    steps = [l for l in out.splitlines() if l.startswith("Step")]
    assert [l.split(" subg_nv")[0] for l in steps] == [
        f"Step {s:3d}" for s in range(4)]
    assert all(len(l.split("subg_nv [")[1].split("]")[0].split(",")) == 2
               for l in steps)
    assert [l.split(" subg_nv")[0] for l in steps if "val_acc" in l] == [
        "Step   2"]
    assert "Average time per DP step (2 subgraphs):" in out
    acc = float(out.split("Test accuracy:", 1)[1].split()[0])
    assert 0.0 <= acc <= 1.0


def test_cli_dp_route(dataset):
    """tests/test_dp_saint.py::test_train_cli_dp_saint's lines, on 2
    ranks."""
    _check_dp_lines(_cli("train", "gcn", dataset, *ARGV, "--device=cpu",
                         GAB_DP="2"))
    if not torch.cuda.is_available():   # no fallback to the CPU
        r = _cli("train", "gcn", dataset, *ARGV, GAB_DP="2")
        assert r.returncode != 0 and "Step" not in r.stdout
        assert "no CUDA device" in r.stderr


def test_cli_dp_route_beside_shards(dataset):
    """GAB_SHARDS (and GAB_TP) route full-batch training only: with
    subg_size > 0, GAB_DP's sampled trainer runs on GAB_DP's ranks, as
    in the JAX CLI."""
    _check_dp_lines(_cli("train", "gcn", dataset, *ARGV, "--device=cpu",
                         GAB_DP="2", GAB_SHARDS="4", GAB_TP="2"))
