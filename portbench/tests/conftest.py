"""Fixtures of the benchmark's own tests, which run on the CPU without a card.

    python -m pytest portbench/tests -q

``tiny_root`` is a checkout root of a small size: ``BENCHMARK.json`` and the
two configurations with the products shape's widths (100 -> 256 -> 256 ->
47) on R-MAT draws at scale 13 cut to 5,000 vertices and 30,000 pairs, in
place of scale 22 cut to the published products counts. The harness's own files
(mixes, limits, readers, kernels) are the repository's; the graph cache goes
to a temporary directory. Tests that need the card carry the ``cuda`` marker
and skip inside the ``cuda_device`` fixture.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_GRAPH = {"generator": "rmat", "scale": 13, "edge_factor": 8, "seed": 0,
              "a": 0.57, "b": 0.19, "c": 0.19, "num_nodes": 5000,
              "num_edges_undirected": 30000}
TINY_TRAIN = 600


def shrink(root: Path) -> None:
    """Point every configuration under ``root`` at the tiny graph."""
    from portbench import graphgen

    draws = {k: TINY_GRAPH[k] for k in ("scale", "edge_factor", "seed", "a",
                                        "b", "c")}
    row_ptr, col_idx = graphgen.undirected_csr(
        *graphgen.rmat_draws(**draws), TINY_GRAPH["num_nodes"], "cpu",
        TINY_GRAPH["num_edges_undirected"])
    for conf in json.loads((root / "BENCHMARK.json").read_text())["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        cfg.update(graph=TINY_GRAPH, num_nodes=len(row_ptr) - 1,
                   num_edges=len(col_idx), train_nodes=TINY_TRAIN)
        path.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path, monkeypatch) -> Path:
    from portbench import graphgen

    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "portbench" / "configs", root / "portbench" / "configs")
    monkeypatch.setattr(graphgen, "CACHE_DIR", tmp_path / "graphs")
    shrink(root)
    return root


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
