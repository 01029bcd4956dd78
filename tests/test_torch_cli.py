"""The port's CLI: ``train gcn|sage|gat|ggnn`` runs end to end on the CPU,
full-batch, inductive and GraphSAINT-sampled, with ``--timers`` and
``--profile``, printing what the JAX CLI prints; the routes it refuses
exit 2 with the reason."""

import os
import subprocess
import sys

import pytest
import torch

from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.graph.io import Meta, save_graph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """rmat(9, 8) written by the port's own save_graph (the JAX CLI reads
    it too)."""
    path = str(tmp_path_factory.mktemp("rmat9"))
    g = rmat(9, 8, seed=0)
    # no feature or label files: load_gnn_dataset synthesizes both
    save_graph(g, path, meta=Meta(nv=g.nv, ne=g.ne, num_vertex_classes=4,
                                  train=(0, 256, 256), val=(256, 384, 128),
                                  test=(384, 512, 128)))
    return path


def _cli(*args, module="graphaibench_tpu_torch.cli", **extra_env):
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra_env)
    for name in ("GAB_SHARDS", "GAB_DP", "GAB_TP"):
        if name not in extra_env:
            env.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", module, *args],
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


SAMPLED = ("0", "softmax", "16", "0", "0", "0.02", "2", "64")
ROUTES = {
    # name: (argv after the dataset, epoch lines carry subg_nv, timer tags)
    "gat_sampled": (("gat", "{ds}", "3", *SAMPLED, "--device=cpu"), True, ()),
    "gcn_sampled": (("gcn", "{ds}", "3", *SAMPLED, "--device=cpu"), True, ()),
    "gcn_timers": (("gcn", "{ds}", "3", "--timers", "--device=cpu"), False,
                   ("step", "eval")),
    "gcn_inductive": (("gcn", "{ds}", "3", "0", "softmax", "16", "0", "0",
                       "0.02", "2", "0", "50", "1", "--device=cpu"), False, ()),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_ported_routes_run(dataset, name):
    """The routes that used to be refused: sampled training (two
    architectures), ``--timers`` and ``inductive=1``."""
    args, sampled, tags = ROUTES[name]
    r = _cli("train", *(a.format(ds=dataset) for a in args))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    epochs = [l for l in lines if l.startswith("Epoch")]
    assert len(epochs) == 3
    assert all((" subg_nv " in l) == sampled for l in epochs)
    assert any(l.startswith("Test accuracy:") for l in lines)
    assert ("Per-op time breakdown:" in lines) == bool(tags)
    for tag in tags:
        assert any(l.split()[:1] == [tag] for l in lines), tag


def _numbers(out):
    """The lines a run prints without their times."""
    keep = []
    for l in out.splitlines():
        if l.startswith("Epoch"):
            keep.append(l.split(" time ")[0])
        elif l.startswith("Test accuracy"):
            keep.append(l)
        elif l.startswith("  ") and " s (" in l:
            keep.append(l.split()[0] + " " + l.split()[-1])   # tag, count
    return keep


def test_sampled_timers_print_what_the_jax_cli_prints(dataset):
    """``train gat <ds> 3 ... subg_size=128 --timers``: the epoch lines
    (subg_nv, loss and accuracy to the printed three decimals), the test
    accuracy and the timer breakdown's tags and counts equal the JAX
    CLI's."""
    args = ("train", "gat", dataset, "3", "0", "softmax", "16", "0", "0",
            "0.02", "2", "128", "2", "--timers")
    t = _cli(*args, "--device=cpu")
    j = _cli(*args, module="graphaibench_tpu.cli", JAX_PLATFORMS="cpu")
    assert t.returncode == 0 and j.returncode == 0, t.stderr + j.stderr
    tn, jn = _numbers(t.stdout), _numbers(j.stdout)
    assert sorted(tn) == sorted(jn) and len(tn) == 7   # 3 + 1 + 3 tags
    assert [l for l in tn if l.startswith("Epoch")] == [
        l for l in jn if l.startswith("Epoch")]
    assert "val_acc" in tn[2]
    assert sorted(tn[4:]) == ["eval x2", "sample x3", "step x3"]
    assert any(l.split()[:1] == ["total"] for l in t.stdout.splitlines())


def test_profile_writes_a_chrome_trace(dataset, tmp_path):
    r = _cli("train", "gcn", dataset, "2", "--device=cpu",
             f"--profile={tmp_path}/prof")
    assert r.returncode == 0, r.stderr
    trace = tmp_path / "prof" / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 1000


def test_default_device_does_not_fall_back_to_the_cpu(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli("train", "gcn", dataset, "1")
    assert r.returncode != 0 and "Epoch" not in r.stdout


def test_remaining_refusals_exit_2(dataset, tmp_path):
    # the sharded, tensor-parallel and data-parallel routes run
    # (tests/test_torch_sharded.py, test_torch_tp.py, test_torch_dp_saint.py);
    # GGNN has no tensor-parallel forward, where JAX asserts
    r = _cli("train", "ggnn", dataset, "1", "--device=cpu", GAB_SHARDS="2",
             GAB_TP="2")
    assert r.returncode == 2 and "GAB_TP" in r.stderr and "ggnn" in r.stderr
    prefix = tmp_path / "packed"
    (tmp_path / "packed.meta.json").write_text("{}")
    r = _cli("train", "gcn", str(prefix), "1", "--device=cpu")
    assert r.returncode == 2 and "compressed" in r.stderr
