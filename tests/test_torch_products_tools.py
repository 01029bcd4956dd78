"""The products-shaped tools of the port (``tools/products_bench_torch.py``,
``tools/products_convergence_torch.py``) run end to end at scale 8 on the
CPU: every section present and error-free, the losses finite, remat's run
equal to the plain one (no dropout: the same float operations), the sharded
trainer at one rank within 1e-5 of ``Model`` (float32 sums in another
order), and no module of JAX loaded."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gcn", "sage", "gat", "ggnn")


def _run(tool: str, *args) -> dict:
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{tool!r}, *{list(args)!r}]\n"
        "try:\n"
        f"    runpy.run_path({tool!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'graphaibench_tpu')]\n"
        "assert not bad, bad[:5]\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PRODUCTS_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_products_bench_runs_at_scale_8_on_cpu():
    out = _run("tools/products_bench_torch.py", "--device=cpu", "--scale=8",
               "--ef=8", "--epochs=2")
    assert out["metric"] == "products_shaped_epoch" and out["nv"] == 256
    assert out["device"] == "cpu" and out["card"] is None
    for arch in ARCHS:
        plain, remat = out[arch], out[f"{arch}_remat"]
        for rec in (plain, remat):
            assert "error" not in rec, rec
            assert len(rec["losses"]) == 2
            assert np.isfinite(rec["losses"]).all()
            # device numbers come from the card only
            assert rec["epoch_device_ms"] is None
            assert rec["epoch_peak_gib"] is rec["setup_peak_gib"] is None
        assert remat["losses"] == plain["losses"]
    sharded = out["gcn_sharded_p1"]
    assert "error" not in sharded, sharded
    np.testing.assert_allclose(sharded["losses"], out["gcn"]["losses"],
                               rtol=1e-5)


def test_products_bench_records_an_error_and_goes_on():
    """A section that fails is recorded with its message, and the next
    one runs: an arch the port does not know."""
    out = _run("tools/products_bench_torch.py", "--device=cpu", "--scale=7",
               "--ef=4", "--epochs=1", "--archs=gin,gcn", "--no-sharded")
    assert "unknown arch" in out["gin"]["error"]
    assert "error" not in out["gcn"] and "gcn_sharded_p1" not in out


def test_oom_record_reads_the_bytes_asked_for():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import products_bench_torch as pb
    finally:
        sys.path.pop(0)
    rec = pb.oom_record(RuntimeError(
        "CUDA out of memory. Tried to allocate 3.25 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB"))
    assert rec["asked_bytes"] == int(3.25 * 2**30)
    assert "error" in pb.oom_record(RuntimeError("another error"))


def test_products_convergence_runs_at_scale_8_on_cpu():
    out = _run("tools/products_convergence_torch.py", "--device=cpu",
               "--scale=8", "--ef=8", "--epochs=4")
    assert out["metric"] == "products_shaped_convergence"
    assert out["recipe"].startswith("sage 3x256")
    nv = out["nv"]
    assert out["train"] == [0, int(nv * 0.08), int(nv * 0.08)]
    runs = out["runs"]
    assert set(runs) == {"remat", "plain"}
    for run in runs.values():
        assert "error" not in run, run
        assert [e["epoch"] for e in run["epochs"]] == [0, 1, 2, 3]
        assert [("val_acc" in e) for e in run["epochs"]] == [False, True,
                                                               False, True]
        assert 0.0 <= run["test_acc"] <= 1.0
        assert run["epoch_peak_gib"] is run["held_gib"] is None
        assert run["classes_used"] > 1
    assert ([e["train_loss"] for e in runs["remat"]["epochs"]]
            == [e["train_loss"] for e in runs["plain"]["epochs"]])


def _remat_memory_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import remat_memory_torch as rm
    finally:
        sys.path.pop(0)
    return rm


def test_remat_memory_peak_report_on_a_synthetic_trace():
    """``tools/remat_memory_torch.py``'s reading of a memory history: the
    peak's bytes and part, what of the held bytes is still live there, and
    the live allocations grouped by the port's innermost line and by
    recompute (an allocation of the backward under the checkpoint, not one
    of the checkpointed forward); the part markers count for nothing."""
    rm = _remat_memory_tool()
    port = os.path.join("x", "graphaibench_tpu_torch", "nn", "layers.py")
    ckpt = os.path.join("torch", "utils", "checkpoint.py")
    marker = [{"filename": "tool.py", "line": 1, "name": rm.MARKER}]
    fwd = [{"filename": port, "line": 9, "name": "sage_layer_fwd"},
           {"filename": "model.py", "line": 2, "name": "train"}]
    again = [fwd[0], {"filename": ckpt, "line": 5, "name": "unpack"}]

    def ev(action, addr, size, frames=()):
        return {"action": action, "addr": addr, "size": size,
                "frames": list(frames)}

    in_ckpt = [fwd[0], {"filename": ckpt, "line": 3, "name": "checkpoint"}]
    trace = [ev("alloc", 1, 512, marker), ev("free_completed", 1, 512),
             ev("alloc", 10, 3 * rm.GIB, fwd),                # forward
             ev("alloc", 14, 1 * rm.GIB, in_ckpt),            # checkpointed
             ev("alloc", 2, 512, marker), ev("free_completed", 2, 512),
             ev("free_completed", 99, 1 * rm.GIB),            # held, freed
             ev("alloc", 11, 2 * rm.GIB, again),              # recompute
             ev("alloc", 12, 1 * rm.GIB),                     # autograd op
             ev("free_completed", 11, 2 * rm.GIB),
             ev("alloc", 3, 512, marker), ev("free_completed", 3, 512),
             ev("alloc", 13, 1 * rm.GIB)]
    rep = rm.peak_report(trace, held=3 * rm.GIB, top=5)
    assert rep["peak_gib"] == 9.0
    assert rep["peak_part"] == "backward"
    assert rep["held_still_live_gib"] == 2.0
    assert rep["made_in_step_gib"] == 7.0
    assert rep["recomputed_gib"] == 2.0
    assert rep["top"] == [
        {"site": "nn/layers.py:9 sage_layer_fwd", "made_in": "forward",
         "recomputed": False, "gib": 4.0, "count": 2},
        {"site": "nn/layers.py:9 sage_layer_fwd", "made_in": "backward",
         "recomputed": True, "gib": 2.0, "count": 1},
        {"site": "no Python frame", "made_in": "backward",
         "recomputed": False, "gib": 1.0, "count": 1}]


def test_remat_memory_tool_needs_a_card():
    r = subprocess.run([sys.executable, "tools/remat_memory_torch.py",
                        "--scale=6", "--ef=4"], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 1 and r.stdout == ""
    assert "CUDA card" in r.stderr
