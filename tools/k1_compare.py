#!/usr/bin/env python3
"""Time kernel K1 (the port's ELL SpMM) of two checkouts on one CUDA card,
in one run: parent, change, change, parent.

    git archive <parent commit> | tar -x -C build/parent   # a gitignored dir
    python3 tools/k1_compare.py --parent build/parent [--tiles 128,64,32]
    python3 tools/k1_compare.py --scale 19 --tiles 128,64,32   # change alone

The change is the checkout this script lies in. Each of the four turns is
a process of its own that imports ``graphaibench_tpu_torch`` from its
tree, builds that tree's kernel with nvcc, holds ``ell_spmm`` against
``ell_spmm_plain`` (rtol = atol = 1e-4: float32 sums in another order,
atomics on split rows) and times it on the GCN main path's graph,
rmat(17, 16) with self-loops and GCN edge norms (``--scale`` for another
size), for F in {128, 16} and both weight views. Without ``--parent`` the
change alone takes one turn. A time is the median over 7 batches of 20 back-to-back
calls between one pair of CUDA events, divided by the count; x stays in
L2 as the last call left it.

``--tiles`` also times the change at F = 128 with its feature tile forced
to each given width (floats), in the same process as its own choice.

Prints the card's nvidia-smi name and power limit, one line per turn, and
a last JSON line with every time in ms. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

EDGE_FACTOR = 16
WIDTHS = (128, 16)
CALLS, BATCHES = 20, 7
TOL = 1e-4


def _batch_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def worker(tree: str, graph_npz: str, tiles: list[int]) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
    from graphaibench_tpu_torch.ops import ell_spmm as K1
    from graphaibench_tpu_torch.ops.device_graph import (
        pack_edge_values,
        to_device_graph,
    )

    z = np.load(graph_npz)
    gp = prepare_graph(CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"]),
                       "gcn")
    dg = to_device_graph(gp, device="cuda")
    wp = pack_edge_values(dg, torch.from_numpy(
        aggregation_weights(gp, "gcn")).cuda())
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": tree, "launches_per_spmm": None, "ms": {}, "tile_ms": {}}
    for f in WIDTHS:
        x = torch.randn(dg.nv, f, device="cuda", generator=gen)
        for view in ("fwd", "t"):
            w = getattr(wp, view)
            before = K1.LAUNCHES
            out = K1.ell_spmm(dg, w, x)
            res["launches_per_spmm"] = K1.LAUNCHES - before
            torch.testing.assert_close(out, K1.ell_spmm_plain(dg, w, x),
                                       rtol=TOL, atol=TOL)
            res["ms"][f"F{f}_{view}"] = _batch_ms(
                torch, lambda: K1.ell_spmm(dg, w, x))
            if f == WIDTHS[0] and tiles and hasattr(K1, "_tile_floats"):
                chosen = K1._tile_floats
                try:
                    for t in tiles:
                        K1._tile_floats = lambda nv, f_, t=t: min(t, f_)
                        torch.testing.assert_close(
                            K1.ell_spmm(dg, w, x), out, rtol=TOL, atol=TOL)
                        res["tile_ms"][f"F{f}_{view}_tile{t}"] = _batch_ms(
                            torch, lambda: K1.ell_spmm(dg, w, x))
                finally:
                    K1._tile_floats = chosen
    print("K1_COMPARE " + json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent commit's checkout")
    ap.add_argument("--scale", type=int, default=17,
                    help="the graph is rmat(scale, 16) with self-loops")
    ap.add_argument("--tiles", default="",
                    help="feature tiles (floats) to force on the change, "
                         "comma-separated")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "GRAPH_NPZ"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    tiles = [int(t) for t in args.tiles.split(",") if t]
    if args.worker:
        worker(args.worker[0], args.worker[1], tiles)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_compare needs a CUDA device", file=sys.stderr)
        return 1
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, change)
    from graphaibench_tpu_torch import rmat

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "graph.npz")
        g = rmat(args.scale, EDGE_FACTOR, seed=0, cache=False)
        np.savez(npz, row_ptr=g.row_ptr, col_idx=g.col_idx)
        print(f"rmat({args.scale}, {EDGE_FACTOR}): nv={g.nv} ne={g.ne} "
              "before self-loops")
        order = [("change", change)]
        if args.parent:
            order = [("parent", args.parent), *order, *order,
                     ("parent", args.parent)]
        for name, tree in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree,
                   npz]
            if tiles and name == "change":
                cmd.append(f"--tiles={args.tiles}")
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            lines = [l for l in r.stdout.splitlines()
                     if l.startswith("K1_COMPARE ")]
            if r.returncode != 0 or not lines:
                print(r.stdout[-4000:], r.stderr[-8000:], sep="\n",
                      file=sys.stderr)
                print(f"the {name} turn failed with code {r.returncode}",
                      file=sys.stderr)
                return 1
            res = json.loads(lines[-1][len("K1_COMPARE "):])
            res["turn"] = name
            turns.append(res)
            print(f"{name}: launches/SpMM {res['launches_per_spmm']} "
                  + " ".join(f"{k} {v:.4f} ms" for k, v in
                             {**res["ms"], **res["tile_ms"]}.items()))
    print(json.dumps({"card": card, "scale": args.scale, "turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
