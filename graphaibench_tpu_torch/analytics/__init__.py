"""Graph analytics solvers of the port, each paired with a serial oracle
in ``verifiers.py`` (the reference's verifier pattern); ``run_benchmark``
prints Correct/Wrong like the reference binaries' main.cc.

Counterpart of ``graphaibench_tpu/analytics/``: the pull-mode solvers BFS,
SSSP, PageRank and CC, whose sweeps run the kernel ``neighbor_reduce``
(``ops/ell_pull.py``) on a CUDA graph; triangle counting on the kernel
``tc_count`` (``ops/tc_count.py``); k-core on the kernel ``hindex_sweep``
(``ops/hindex.py``), or on ``neighbor_reduce`` by peeling; betweenness
centrality on ``neighbor_reduce``. A compressed-graph prefix decodes on
the device: CGR through the kernels K12 (``compress/cgr_device.py``),
StreamVByte, VarintGB and hybrids of StreamVByte chunks through K11
(``compress/device_decode.py``); on the host where the device route refuses
the stream's shape (a hybrid of VarintGB chunks, for one). With
``GAB_TC_STREAM=1`` the triangles of a CGR prefix are counted block by
block off the stream (``tc_stream.py``). ``GAB_SHARDS=<n|auto>`` runs the
distributed solvers (``parallel/dist_analytics.py``) on n ranks spawned on
this host, the graph vertex-sharded over them (``_run_distributed``).
Coloring runs on the kernel ``first_fit`` (``ops/first_fit.py``);
collaborative filtering on ``sddmm_dot_ell`` and K1; Borůvka's spanning
forest, k-hop sampling, random walks, DeepWalk, node2vec and kNN search in
plain PyTorch on the device. The pattern solvers: motif counting
(``motif.py``) on dense matrix products on the device, its counts reduced
in float64; FSM (``fsm.py``) on the NLF table, one K1 SpMM
(``graph/labels.py``), and dense products. Louvain, link prediction, HAC
and the Hungarian assignment are the JAX package's host numpy, copied.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from graphaibench_tpu_torch.analytics import verifiers  # noqa: F401
from graphaibench_tpu_torch.analytics.ann import knn_search  # noqa: F401
from graphaibench_tpu_torch.analytics.assignment import hungarian  # noqa: F401
from graphaibench_tpu_torch.analytics.bc import (  # noqa: F401
    bc_single_source,
    betweenness_centrality,
)
from graphaibench_tpu_torch.analytics.cc import (  # noqa: F401
    connected_components,
    connected_components_afforest,
)
from graphaibench_tpu_torch.analytics.cf import cf_train  # noqa: F401
from graphaibench_tpu_torch.analytics.coloring import color  # noqa: F401
from graphaibench_tpu_torch.analytics.community import (  # noqa: F401
    louvain,
    modularity,
)
from graphaibench_tpu_torch.analytics.embedding import (  # noqa: F401
    deepwalk,
    node2vec,
)
from graphaibench_tpu_torch.analytics.fsm import fsm as run_fsm  # noqa: F401
from graphaibench_tpu_torch.analytics.hac import (  # noqa: F401
    cut_clusters,
    hac,
    hac_from_embeddings,
)
from graphaibench_tpu_torch.analytics.kcore import (  # noqa: F401
    k_core,
    k_core_hindex,
    k_core_peel,
)
from graphaibench_tpu_torch.analytics.khop import (  # noqa: F401
    khop_sample,
    random_walk,
)
from graphaibench_tpu_torch.analytics.linkpred import (  # noqa: F401
    adamic_adar,
    jaccard,
    predict_links,
)
from graphaibench_tpu_torch.analytics.motif import (  # noqa: F401
    induced_motif_counts,
    motif_counts,
)
from graphaibench_tpu_torch.analytics.mst import boruvka_mst  # noqa: F401
from graphaibench_tpu_torch.analytics.pr import pagerank  # noqa: F401
from graphaibench_tpu_torch.analytics.tc import triangle_count  # noqa: F401
from graphaibench_tpu_torch.analytics.tc_stream import (  # noqa: F401
    bfs_streaming,
    triangle_count_streaming,
)
from graphaibench_tpu_torch.analytics.traversal import (  # noqa: F401
    bfs,
    bfs_frontier,
    bfs_host,
    sssp_bellman_ford,
    sssp_delta_stepping,
)

PORTED = ("tc", "bfs", "sssp", "pr", "cc", "bc", "kcore", "color", "cf",
          "motif", "fsm", "embed", "sample")
DISTRIBUTED = ("tc", "bfs", "sssp", "pr", "cc", "bc", "kcore")
# the pull-mode solvers, which take the ELL pull route on symmetric graphs
PULL = ("bfs", "sssp", "pr", "cc", "bc", "kcore")


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _load_compressed(kernel: str, prefix: str, device):
    """The graph of a compressed prefix, decoded on ``device`` (CGR through
    K12, StreamVByte, VarintGB and StreamVByte hybrids through K11) or on
    the host where the device route refuses the stream's shape
    (``StreamRefused``); or the streaming count's exit code."""
    from graphaibench_tpu_torch.compress.cgr import CompressedGraph
    from graphaibench_tpu_torch.compress.cgr_device import (
        StreamRefused,
        cgr_decode_device,
    )
    from graphaibench_tpu_torch.compress.cli import decode_any, load_compressed
    from graphaibench_tpu_torch.compress.device_decode import (
        decode_graph_device,
        decode_hybrid_device,
    )

    cg = load_compressed(prefix)
    if (kernel == "tc" and os.environ.get("GAB_TC_STREAM", "") == "1"
            and isinstance(cg, CompressedGraph)):
        # triangles straight off the compressed adjacency, block pair by
        # block pair (tc_omp_compressed.cc): the whole CSR never exists
        print(f"device = {device}")
        t0 = time.perf_counter()
        try:
            n, stats = triangle_count_streaming(cg, device=device)
        except StreamRefused as e:      # interval or unary streams
            print(f"streaming unsupported ({e}); decode-then-count")
        else:
            dt = time.perf_counter() - t0
            print(f"total_num_triangles = {n} (streaming, "
                  f"{stats['blocks']} blocks)")
            print(f"runtime = {dt:.4f} sec")
            if cg.ne > 200_000:
                return 0
            from graphaibench_tpu_torch.graph.transforms import orientation

            ok = n == verifiers.triangle_count_serial(
                orientation(decode_any(cg)))
            print("Correct" if ok else "Wrong")
            return 0 if ok else 1
    if isinstance(cg, CompressedGraph):
        scheme, decode = "cgr", cgr_decode_device
    elif hasattr(cg, "vbyte_scheme"):
        scheme, decode = "hybrid", decode_hybrid_device
    else:
        scheme, decode = cg.scheme, decode_graph_device
    try:
        g = decode(cg, device=device)
        print(f"decoded {scheme} on device {device}")
    except StreamRefused as e:      # a stream shape the device route refuses
        g = decode_any(cg)
        print(f"decoded on host ({e})")
    return g


def _edge_weights(g) -> np.ndarray:
    return (np.asarray(g.elabels, dtype=np.float32)
            if g.elabels is not None else np.ones(g.ne, np.float32))


def _edge_supports(g, min_sup: int) -> dict:
    """The ``fsm`` route's independent check: each labeled edge's MNI
    support straight from the edge list (no NLF machinery), as the JAX
    route computes it."""
    lab = np.asarray(g.vlabels, dtype=np.int64)
    L = int(lab.max()) + 1
    src, dst = g.coo()
    has = np.zeros((g.nv, L), dtype=bool)
    has[src, lab[dst]] = True
    exp = {}
    for la in range(L):
        for lb in range(la, L):
            na = int(((lab == la) & has[:, lb]).sum())
            nb = int(((lab == lb) & has[:, la]).sum())
            if min(na, nb) >= min_sup:
                exp[(la, lb)] = min(na, nb)
    return exp


def _dist_rank(rank: int, n: int, kernel: str, row_ptr, col_idx, weights,
               source: int, device: str):
    """One rank of ``GAB_SHARDS``: its solver's share, the result gathered
    in vertex order. Rank 0 returns (result, sweep or iteration count,
    seconds), the others None."""
    import torch

    from graphaibench_tpu_torch import parallel as PAR
    from graphaibench_tpu_torch.graph.csr import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device

    g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
    dev = rank_device(rank, device)
    t0 = time.perf_counter()
    count = None
    if kernel == "tc":
        out = PAR.distributed_triangle_count(g, device=dev)
    else:
        if kernel == "bfs":
            x, count = PAR.distributed_bfs(g, source, device=dev)
        elif kernel == "sssp":
            x, count = PAR.distributed_sssp(g, weights, source, device=dev)
        elif kernel == "pr":
            x, count = PAR.distributed_pagerank(g, device=dev)
        elif kernel == "cc":
            x, count = PAR.distributed_cc(g, device=dev)
        elif kernel == "bc":
            x = PAR.distributed_bc(g, [source], device=dev)
        else:
            x, count = PAR.distributed_kcore(g, device=dev)
        out = PAR.gather_own(x, g.nv).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (out, count, time.perf_counter() - t0) if rank == 0 else None


def _run_distributed(kernel: str, g, args: list[str], shards: str,
                     device) -> int:
    """``GAB_SHARDS`` routing: the distributed solver on n ranks spawned
    here (``parallel/multihost.py::launch``; nccl where each rank has a
    card of its own, gloo on the CPU and where ranks share a card), the
    graph given to them as numpy arrays; the same serial verifiers gate
    the result as in JAX's ``_run_distributed``. The runtime is rank 0's
    solve, partition and gather included, spawning not."""
    import torch

    from graphaibench_tpu_torch.graph.transforms import orientation, reverse
    from graphaibench_tpu_torch.parallel.multihost import (
        choose_backend,
        count_ranks,
        launch,
    )

    if device == "cuda" and not torch.cuda.is_available():
        print("GAB_SHARDS: no CUDA device (--device=cpu runs the ranks on "
              "the CPU)", file=sys.stderr)
        return 1
    try:
        n = count_ranks(shards, str(device))
    except ValueError as e:
        return _refuse(str(e))
    backend = choose_backend(n, str(device))
    print(f"distributed over {n} rank(s) on {device} ({backend})")
    source = int(args[0]) if args else 0
    w = _edge_weights(g) if kernel == "sssp" else None
    sys.stdout.flush()
    out, count, dt = launch(_dist_rank, n, kernel, np.asarray(g.row_ptr),
                            np.asarray(g.col_idx), w, source, str(device),
                            device=str(device), backend=backend,
                            timeout_s=None)[0]
    ok = None
    if kernel == "tc":
        print(f"total_num_triangles = {out}")
        if g.ne <= 200_000:
            ok = out == verifiers.triangle_count_serial(orientation(g))
    elif kernel == "bfs":
        reach = out < 2**30
        print(f"reached = {reach.sum()}, sweeps = {count}")
        ref = verifiers.bfs_serial(g, source)
        unreach = ref < 0
        ok = (np.array_equal(out[~unreach], ref[~unreach])
              and bool(np.all(~reach[unreach])))
    elif kernel == "sssp":
        print(f"reached = {np.isfinite(out).sum()}, sweeps = {count}")
        ref = verifiers.dijkstra_serial(g, w, source)
        fin = np.isfinite(ref)
        ok = (np.allclose(out[fin], ref[fin], rtol=1e-5)
              and bool(np.all(~np.isfinite(out[~fin]))))
    elif kernel == "pr":
        print(f"iterations = {count}")
        ok = np.allclose(out, verifiers.pagerank_serial(g, reverse(g)),
                         atol=1e-4)
    elif kernel == "cc":
        print(f"num_components = {len(np.unique(out))}")
        # both labelings are the least vertex id of each component
        ok = np.array_equal(out, verifiers.cc_serial(g))
    elif kernel == "bc":
        ok = np.allclose(out, verifiers.bc_serial(g, [source]), rtol=1e-4,
                         atol=1e-5)
    else:  # kcore
        print(f"max_coreness = {out.max()}")
        ok = np.array_equal(out, verifiers.kcore_serial(g))
    print(f"runtime = {dt:.4f} sec")
    if ok is None:      # a triangle count above the serial check's size
        return 0
    print("Correct" if ok else "Wrong")
    return 0 if ok else 1


def run_benchmark(kernel: str, dataset_path: str, args: list[str], *,
                  device="cuda") -> int:
    """The CLI route: load, solve on ``device``, verify, print Correct/Wrong
    and the runtime; the return value is the exit code."""
    import torch

    from graphaibench_tpu_torch.graph.io import load_graph
    from graphaibench_tpu_torch.graph.transforms import is_symmetric, orientation
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    if kernel not in PORTED:
        print(f"unknown kernel {kernel!r}")
        return 2
    if os.path.exists(dataset_path + ".meta.json"):
        g = _load_compressed(kernel, dataset_path, device)
        if isinstance(g, int):
            return g
    else:
        g = load_graph(dataset_path, with_elabels=(kernel == "cf"),
                       with_vlabels=(kernel == "fsm"))
    print(f"|V| {g.nv} |E| {g.ne}")
    shards = os.environ.get("GAB_SHARDS", "")
    if shards and kernel in DISTRIBUTED:
        # cc, kcore and bc pull over in-edges and are right on symmetric
        # graphs only: directed inputs stay on the single-device push
        # route, as the pull_ok gate below keeps them
        if kernel in ("tc", "bfs", "sssp", "pr") or is_symmetric(g):
            return _run_distributed(kernel, g, args, shards, device)
        print("directed input: distributed "
              f"{kernel} needs a symmetric graph; running single-device")
    print(f"device = {device}")
    # pull-mode frontier kernels (neighbor_reduce over row buckets) assume
    # a structurally symmetric graph; directed inputs keep the scatter push
    # formulation, which stays correct
    pull_ok = kernel in PULL and is_symmetric(g)
    if kernel in PULL and not pull_ok:
        print("directed input: push/scatter kernels (no pull ELL)")
    source = int(args[0]) if args and kernel in PULL else 0
    t0 = time.perf_counter()
    ok = None

    if kernel == "tc":
        n = triangle_count(g, device=device)
        dt = time.perf_counter() - t0
        print(f"total_num_triangles = {n}")
        if g.ne <= 200_000:
            ok = n == verifiers.triangle_count_serial(orientation(g))
    elif kernel == "bfs":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=pull_ok)
        dist = bfs(dg, source).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"reached = {(dist >= 0).sum()}, max_depth = {dist.max()}")
        ok = np.array_equal(dist, verifiers.bfs_serial(g, source))
    elif kernel == "sssp":
        w = _edge_weights(g)
        # the pull gathers each slot's REVERSE-edge weight through
        # trans_perm, so the transpose permutation rides along whenever
        # the pull is taken
        dg = to_device_graph(g, device=device, with_transpose=pull_ok,
                             with_ell=pull_ok)
        dist = sssp_bellman_ford(dg, torch.from_numpy(w).to(device),
                                 source).cpu().numpy()
        dt = time.perf_counter() - t0
        ref = verifiers.dijkstra_serial(g, w, source)
        ok = np.allclose(dist, ref, rtol=1e-5, equal_nan=True)
    elif kernel == "pr":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=pull_ok)
        scores, iters = pagerank(dg)
        scores = scores.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"iterations = {iters}")
        ref = verifiers.pagerank_serial(g, g)
        ok = np.allclose(scores, ref, atol=1e-4)
    elif kernel == "cc":
        if pull_ok:
            # Afforest sampling shortcut (omp_afforest.cc): first-k link
            # rounds + giant-component contraction; symmetric inputs only
            comp = connected_components_afforest(g, device=device)
        else:
            dg = to_device_graph(g, device=device, with_transpose=False,
                                 with_ell=False)
            comp = connected_components(dg).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"num_components = {len(np.unique(comp))}")
        ok = np.array_equal(comp, verifiers.cc_serial(g))
    elif kernel == "bc":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=pull_ok)
        scores = bc_single_source(dg, source).cpu().numpy()
        dt = time.perf_counter() - t0
        ok = np.allclose(scores, verifiers.bc_serial(g, [source]), rtol=1e-4)
    elif kernel == "kcore":
        if pull_ok:
            # the h-index fixpoint
            core = k_core(None, host=g, device=device).cpu().numpy()
        else:
            dg = to_device_graph(g, device=device, with_transpose=False,
                                 with_ell=False)
            core = k_core(dg).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"max_coreness = {core.max()}")
        ok = np.array_equal(core, verifiers.kcore_serial(g))
    elif kernel == "color":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=False)
        colors = color(dg).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"num_colors = {len(np.unique(colors))}")
        ok = verifiers.coloring_valid(g, colors)
    elif kernel == "cf":
        lat, hist = cf_train(g, _edge_weights(g), device=device)
        dt = time.perf_counter() - t0
        print("RMSE history:", " ".join(f"{h:.4f}" for h in hist))
        ok = hist[-1] <= hist[0]
    elif kernel == "motif":
        k = int(args[0]) if args else 4
        induced = len(args) > 1 and args[1] == "induced"
        if induced and k == 3:
            ni = motif_counts(g, 3, device=device)
            counts = {"triangle": ni["triangle"],
                      "wedge": ni["wedge"] - 3 * ni["triangle"]}
        elif induced:
            counts = induced_motif_counts(g, device=device)
        else:
            counts = motif_counts(g, k, device=device)
        dt = time.perf_counter() - t0
        for name, c in sorted(counts.items()):
            print(f"{name} = {c}")
        if g.ne <= 200_000:
            ok = counts.get("triangle") == verifiers.triangle_count_serial(
                orientation(g))
    elif kernel == "fsm":
        min_sup = int(args[0]) if args else 1
        max_size = int(args[1]) if len(args) > 1 else 3
        if g.vlabels is None:
            print("dataset has no vertex labels")
            return 2
        pats = run_fsm(g, min_support=min_sup, max_size=max_size,
                       device=device)
        dt = time.perf_counter() - t0
        for f in sorted(pats, key=lambda f: -f.support)[:40]:
            print(f"{f.kind} {f.labels} support={f.support}")
        print(f"num_frequent_patterns = {len(pats)}")
        if g.ne <= 5_000_000:
            ok = _edge_supports(g, min_sup) == {
                f.labels: f.support for f in pats if f.kind == "edge"}
    elif kernel == "embed":
        algo = args[0] if args else "deepwalk"
        dim = int(args[1]) if len(args) > 1 else 64
        fn = node2vec if algo == "node2vec" else deepwalk
        emb = fn(g, dim=dim, device=device)
        dt = time.perf_counter() - t0
        print(f"{algo} embeddings {emb.shape}, mean norm "
              f"{np.linalg.norm(emb, axis=1).mean():.4f}")
        ok = bool(np.isfinite(emb).all())
    else:  # sample
        hops = khop_sample(g, np.arange(min(64, g.nv)), device=device)
        dt = time.perf_counter() - t0
        print("sampled edges per hop:", [len(s) for s, _ in hops])
        ok = True

    print(f"runtime = {dt:.4f} sec")
    if ok is None:      # a count above its serial check's size
        return 0
    print("Correct" if ok else "Wrong")
    return 0 if ok else 1
