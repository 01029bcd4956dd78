"""The port's CLI: ``train gcn|sage|gat|ggnn`` runs end to end on the CPU,
and routes not ported yet exit non-zero naming their ROADMAP item."""

import os
import subprocess
import sys

import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.io import Meta, save_graph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rmat9"))
    g = rmat(9, 8, seed=0)
    # no feature or label files: load_gnn_dataset synthesizes both
    save_graph(g, path, meta=Meta(nv=g.nv, ne=g.ne, num_vertex_classes=4,
                                  train=(0, 256, 256), val=(256, 384, 128),
                                  test=(384, 512, 128)))
    return path


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("GAB_SHARDS", None)
    return subprocess.run(
        [sys.executable, "-m", "graphaibench_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def test_train_gcn_on_cpu(dataset):
    r = _cli("train", "gcn", dataset, "3", "0", "softmax", "16",
             "--device=cpu")
    assert r.returncode == 0, r.stderr
    epochs = [l for l in r.stdout.splitlines() if l.startswith("Epoch")]
    assert len(epochs) == 3
    assert "train_loss" in epochs[0]
    assert any(l.startswith("Test accuracy:") for l in r.stdout.splitlines())


@pytest.mark.parametrize("arch", ["sage", "gat", "ggnn"])
def test_train_other_archs_on_cpu(dataset, arch):
    r = _cli("train", arch, dataset, "3", "0", "softmax", "16",
             "--device=cpu")
    assert r.returncode == 0, r.stderr
    epochs = [l for l in r.stdout.splitlines() if l.startswith("Epoch")]
    assert len(epochs) == 3
    losses = [float(l.split("train_loss")[1].split()[0]) for l in epochs]
    assert losses[-1] < losses[0]
    assert any(l.startswith("Test accuracy:") for l in r.stdout.splitlines())


def test_unknown_arch_exits_nonzero(dataset):
    r = _cli("train", "gin", dataset, "1", "--device=cpu")
    assert r.returncode == 2 and "unknown arch" in r.stderr


@pytest.mark.parametrize("args,item", [
    (("train", "gat", "{ds}", "1", "0", "softmax", "16", "0", "0", "0.02",
      "2", "64", "--device=cpu"), "P9"),
    (("train", "gcn", "{ds}", "1", "0", "softmax", "16", "0", "0", "0.02",
      "2", "64", "--device=cpu"), "P9"),
    (("train", "gcn", "{ds}", "1", "--timers", "--device=cpu"), "P10"),
    (("train", "gcn", "{ds}", "1", "0", "softmax", "16", "0", "0", "0.02",
      "2", "0", "50", "1", "--device=cpu"), "P6"),
])
def test_unported_routes_exit_nonzero(dataset, args, item):
    r = _cli(*(a.format(ds=dataset) for a in args))
    assert r.returncode != 0
    assert "ROADMAP" in r.stderr and item in r.stderr
