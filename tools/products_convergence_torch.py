"""Products-shaped SAGE convergence run of the PyTorch port, one card.

The recipe of the JAX tool ``tools/products_convergence.py`` (the
reference's ``cpu_train_sage ogbn-products 10 32 softmax 256 0 0 0.01 3 0
50 0``, scripts/run-sage-products.sh:1): SAGE, 3 layers, hidden 256, lr
0.01, 10 epochs, softmax loss, on the products-shaped synthetic graph of
``tools/products_bench_torch.py`` (``rmat(21, 26, seed=0)``, feat 100, 47
classes) with PLANTED teacher labels (the argmax of one normalised
aggregation of the features times a random readout, plus noise), so that
accuracy has signal to climb, and an ogbn-products-like range split (8%
train, 2% validation, the rest test).

With ``cfg.remat`` on (as the JAX tool sets it for this stack) and off: per
epoch the train loss and accuracy and the
host seconds, the validation accuracy every ``--val-every`` epochs, the
test accuracy, and the memory: the set-up's peak, what the model holds after
it and the peak over the epochs (everything held included). Prints a line per epoch and, last, one JSON object.
Imports nothing of JAX.

    python3 tools/products_convergence_torch.py [--device cuda|cpu]
        [--scale 21] [--ef 26] [--epochs 10]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from products_bench_torch import (  # noqa: E402
    CLASSES,
    FEAT,
    card_line,
    oom_record,
    peak_gib,
    products_dataset,
    reset_peak,
    set_up_memory,
)

TEACHER_NOISE = 0.5


def planted_labels(model) -> torch.Tensor:
    """argmax(A X W + noise) with the model's normalised aggregation A (its
    full graph's SAGE weights), W (feat, classes) standard normal from seed
    7 and noise 0.5 x standard normal from seed 8, both drawn with numpy."""
    from graphaibench_tpu_torch.ops.spmm import spmm

    dev = model.device
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (FEAT, CLASSES)).astype(np.float32)).to(dev)
    noise = torch.from_numpy((TEACHER_NOISE * np.random.default_rng(8)
                              .standard_normal((model.full.device.nv, CLASSES)))
                             .astype(np.float32)).to(dev)
    with torch.no_grad():
        agg = spmm(model.full.device, model.full.edge_w_agg, model.feats)
        return (agg @ w + noise).argmax(1)


def run(ds, remat: bool, args) -> dict:
    from graphaibench_tpu_torch.nn import Model
    from graphaibench_tpu_torch.nn.layers import ModelConfig

    cfg = ModelConfig(arch=args.arch, num_layers=args.layers, dim_init=FEAT,
                      dim_hid=args.hidden, num_cls=CLASSES, lr=0.01,
                      remat=remat)
    reset_peak(args.device)
    m = Model(cfg, ds, device=args.device)
    m.labels = planted_labels(m)
    out = {"remat": remat, "classes_used": int(len(torch.unique(m.labels))),
           **set_up_memory(args.device), "epochs": []}
    for ep in range(args.epochs):
        t0 = time.perf_counter()
        loss, acc = m.train_epoch()
        rec = {"epoch": ep, "train_loss": loss, "train_acc": acc,
               "time_s": time.perf_counter() - t0}
        if ep % args.val_every == args.val_every - 1:
            rec["val_acc"] = m.evaluate("val")
        out["epochs"].append(rec)
        print(json.dumps(rec), flush=True)
    out["test_acc"] = m.evaluate("test")
    out["epoch_peak_gib"] = peak_gib(args.device)
    losses = [e["train_loss"] for e in out["epochs"]]
    out["loss_decreased"] = bool(losses[-1] < losses[0])
    del m
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=26)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--arch", default="sage")
    ap.add_argument("--val-every", type=int, default=2)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (--device=cpu runs on the CPU)", file=sys.stderr)
        return 1
    card = card_line(args.device)
    if card:
        print(card, flush=True)
    ds, build_s = products_dataset(args.scale, args.ef, train_share=0.08,
                                   val_share=0.02)
    print(f"graph |V| {ds.graph.nv} |E| {ds.graph.ne} ({build_s:.0f} s)",
          flush=True)
    out = {"metric": "products_shaped_convergence", "device": args.device,
           "card": card,
           "recipe": f"{args.arch} {args.layers}x{args.hidden} lr0.01 "
                     "softmax (run-sage-products.sh shape)",
           "nv": ds.graph.nv, "ne": ds.graph.ne, "train": ds.train_range,
           "val": ds.val_range, "test": ds.test_range, "runs": {}}
    for remat in (True, False):
        key = "remat" if remat else "plain"
        try:
            out["runs"][key] = run(ds, remat, args)
        except Exception as e:  # noqa: BLE001 - an OOM is a result
            out["runs"][key] = oom_record(e)
        finally:
            # the model's reference cycles, or the next run counts its
            # tensors as held
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
