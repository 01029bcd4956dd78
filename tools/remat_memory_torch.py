"""Where one products-shaped training step's memory peaks, with remat and without.

For each model of ``--models`` (``arch:LAYERSxHIDDEN``; by default SAGE
3 x 256, the recipe of ``tools/products_convergence_torch.py``) on the
products-shaped graph of ``tools/products_bench_torch.py`` (``rmat(21, 26,
seed=0)``, feat 100, 47 classes), with ``cfg.remat`` off and on: one warm
``Model.train_epoch``, one more with the allocator's peak reset (the
epoch's peak, as the products tools read it), then one step of the same
body (``zero_grad``, ``apply_model``, the loss, ``backward``, the
optimizer's step) under the allocator's memory history
(``torch.cuda.memory._record_memory_history``, Python stacks). Prints per
run the bytes held before the step; each part's peak and what stays live
after it; and at the step's peak, the part in which it falls and the live
allocations grouped by the line of the port that made them (the innermost
frame under ``graphaibench_tpu_torch/``; the autograd engine's own backward
ops have no Python frame), each marked where ``torch.utils.checkpoint``
recomputed it (made in the backward under the checkpoint). Last, one JSON object. Needs one CUDA card; imports nothing
of JAX.

    python3 tools/remat_memory_torch.py [--scale 21] [--ef 26]
        [--models sage:3x256,gcn:2x128] [--top 12]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from products_bench_torch import (  # noqa: E402
    CLASSES,
    FEAT,
    card_line,
    products_dataset,
)

GIB = 2**30
PARTS = ("zero_grad", "forward", "backward", "step")
MARKER = "_part_marker"
PORT = "graphaibench_tpu_torch"
RECOMPUTE = os.path.join("utils", "checkpoint.py")


def _site(frames: list) -> tuple[str, bool]:
    """The innermost frame of the port (``file:line function``, or
    ``no Python frame``), and whether the checkpoint is on the stack."""
    site = next((f"{f['filename'].split(PORT + os.sep)[-1]}:{f['line']} "
                 f"{f['name']}" for f in frames if PORT in f["filename"]),
                "no Python frame" if not frames else "outside the port")
    return site, any(f["filename"].endswith(RECOMPUTE) for f in frames)


def peak_report(trace: list, held: int, top: int) -> dict:
    """The peak of a memory-history trace over one step that starts with
    ``held`` bytes allocated: its bytes, the part of the step it falls in
    (parts split by the allocations of ``_part_marker``, in ``PARTS``
    order), what was held before the step and is still live there, and the
    ``top`` largest groups of the allocations live there, by site, part and
    recompute."""
    live, markers = {}, set()
    cur, part, pre_freed = held, 0, 0
    peak = {"bytes": held, "part": 0, "live": {}, "pre_freed": 0}
    for e in trace:
        action, addr = e["action"], e["addr"]
        frames = e.get("frames") or []
        if action == "alloc" and any(f["name"] == MARKER for f in frames):
            markers.add(addr)
            part += 1
        elif action == "alloc":
            site, in_checkpoint = _site(frames)
            recomputed = in_checkpoint and part == PARTS.index("backward")
            live[addr] = (e["size"], site, recomputed, part)
            cur += e["size"]
            if cur > peak["bytes"]:
                peak = {"bytes": cur, "part": part, "live": dict(live),
                        "pre_freed": pre_freed}
        elif action == "free_completed":
            if addr in markers:
                markers.discard(addr)
            elif addr in live:
                cur -= live.pop(addr)[0]
            else:
                cur -= e["size"]
                pre_freed += e["size"]
    groups = {}
    for size, site, recomputed, made_in in peak["live"].values():
        key = (site, PARTS[min(made_in, len(PARTS) - 1)], recomputed)
        g = groups.setdefault(key, {"bytes": 0, "count": 0})
        g["bytes"] += size
        g["count"] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1]["bytes"])
    return {
        "peak_gib": peak["bytes"] / GIB,
        "peak_part": PARTS[min(peak["part"], len(PARTS) - 1)],
        "held_still_live_gib": (held - peak["pre_freed"]) / GIB,
        "made_in_step_gib": sum(s for s, *_ in peak["live"].values()) / GIB,
        "recomputed_gib": sum(s for s, _, r, _ in peak["live"].values()
                              if r) / GIB,
        "top": [{"site": site, "made_in": made_in, "recomputed": rec,
                 "gib": g["bytes"] / GIB, "count": g["count"]}
                for (site, made_in, rec), g in ranked[:top]]}


def _part_marker() -> None:
    """A one-element allocation whose frame splits the trace into parts."""
    torch.empty(1, device="cuda")


def traced_step(m) -> dict:
    """``Model.train_epoch``'s step body, each part's peak and the bytes
    live after it read off the allocator, the whole under memory history."""
    from graphaibench_tpu_torch.nn.layers import apply_model
    from graphaibench_tpu_torch.nn.losses import (
        masked_sigmoid_loss,
        masked_softmax_loss,
    )

    parts = {}

    def mark(name):
        torch.cuda.synchronize()
        parts[name] = {"peak_gib": torch.cuda.max_memory_allocated() / GIB,
                       "live_after_gib": torch.cuda.memory_allocated() / GIB}
        torch.cuda.reset_peak_memory_stats()
        _part_marker()

    begin, end, _ = m.ranges["train"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    # stacks of the allocations only: recording the frees' stacks too fails
    # in the checkpoint's recompute (a SystemError, torch 2.11 on the card)
    torch.cuda.memory._record_memory_history(context="alloc", stacks="python",
                                             max_entries=1_000_000)
    try:
        m.opt.zero_grad()
        mark("zero_grad")
        logits = apply_model(m.cfg, m.params, m.training.device,
                             m.training.edge_w_agg, m.feats, train=True,
                             generator=m.generator, trivial_w=True)
        loss_fn = (masked_sigmoid_loss if m.cfg.is_sigmoid
                   else masked_softmax_loss)
        lg, _, _ = loss_fn(logits, m.labels, begin, end, m.masks["train"])
        mark("forward")
        lg.backward()
        mark("backward")
        m.opt.step()
        mark("step")
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    return {"held_gib": held / GIB, "parts": parts,
            "trace_entries": len(trace), "trace": trace, "held": held}


def run(ds, spec: str, remat: bool, top: int) -> dict:
    from graphaibench_tpu_torch.nn import Model
    from graphaibench_tpu_torch.nn.layers import ModelConfig

    arch, shape = spec.split(":")
    layers, hidden = (int(v) for v in shape.split("x"))
    cfg = ModelConfig(arch=arch, num_layers=layers, dim_init=FEAT,
                      dim_hid=hidden, num_cls=CLASSES, lr=0.01, remat=remat)
    m = Model(cfg, ds, device="cuda")
    try:
        m.train_epoch()                                  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m.train_epoch()
        epoch_peak = torch.cuda.max_memory_allocated() / GIB
        rec = traced_step(m)
    finally:
        del m
        gc.collect()
        torch.cuda.empty_cache()
    trace, held = rec.pop("trace"), rec.pop("held")
    rec["train_epoch_peak_gib"] = epoch_peak
    rec["step_peak_gib"] = max(p["peak_gib"] for p in rec["parts"].values())
    rec["at_peak"] = peak_report(trace, held, top)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=26)
    ap.add_argument("--models", default="sage:3x256")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card: the allocator's history is the card's",
              file=sys.stderr)
        return 1
    card = card_line("cuda")
    print(card, flush=True)
    ds, build_s = products_dataset(args.scale, args.ef, train_share=0.08,
                                   val_share=0.02)
    print(f"graph |V| {ds.graph.nv} |E| {ds.graph.ne} ({build_s:.0f} s)",
          flush=True)
    out = {"metric": "remat_step_memory", "card": card, "nv": ds.graph.nv,
           "ne": ds.graph.ne, "runs": {}}
    for spec in args.models.split(","):
        for remat in (False, True):
            key = f"{spec}{' remat' if remat else ''}"
            out["runs"][key] = run(ds, spec, remat, args.top)
            print(f"  {key}: {json.dumps(out['runs'][key])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
