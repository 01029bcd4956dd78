"""Process groups for the sharded trainer, and a launcher of ranks.

Counterpart of ``graphaibench_tpu/parallel/multihost.py::initialize``
(``jax.distributed.initialize``): here one process per rank joins a
``torch.distributed`` process group, given its address, world size and
rank; nothing in the environment is read for them.

The backend follows the devices: ``nccl`` when every rank has a card of
its own, ``gloo`` on the CPU and when several ranks share one card (NCCL
refuses two ranks on one device). gloo's all-to-all takes CPU tensors,
so with CUDA tensors the collectives of ``parallel/halo.py`` copy through
host buffers; ``transport`` names the route, and the trainer prints it.

``launch`` spawns ``n`` ranks on this host with ``torch.multiprocessing``,
runs a function in each inside its process group, and returns every
rank's result; a rank that fails or outlasts the time limit fails the
launch, and no rank outlives it.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

# after a rank fails, the seconds its peers get to report theirs
_GRACE_S = 10.0


def choose_backend(n: int, device: str) -> str:
    """``nccl`` where ``n`` ranks each get a card of their own, ``gloo``
    on the CPU or where ranks share a card."""
    if device == "cpu":
        return "gloo"
    return "nccl" if n <= torch.cuda.device_count() else "gloo"


def count_ranks(spec: str, device: str) -> int:
    """The ranks that ``GAB_SHARDS=<n|auto>`` asks for, in the training
    and the analytics routes alike: ``auto`` is one rank a visible card
    on ``cuda`` and one rank on the CPU (gloo ranks may share a card, so
    a count above the cards is taken as it is). ValueError unless the
    result is a positive count."""
    if spec == "auto":
        n = torch.cuda.device_count() if device == "cuda" else 1
    else:
        try:
            n = int(spec)
        except ValueError:
            n = 0
    if n < 1:
        raise ValueError(f"GAB_SHARDS must be a positive count or auto, "
                         f"not {spec!r}")
    return n


def rank_device(rank: int, device: str) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` modulo the
    visible cards (several ranks share a card when there are fewer)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for CPU ranks")
    return torch.device("cuda", rank % torch.cuda.device_count())


def transport(group=None, device=None) -> str:
    """How the group's collectives move tensors of ``device``: ``device``
    (the backend takes them as they are) or ``host-staged`` (gloo with
    CUDA tensors: copied to host buffers and back)."""
    staged = (dist.get_backend(group) == "gloo" and device is not None
              and torch.device(device).type == "cuda")
    return "host-staged" if staged else "device"


def hybrid_groups(model_parallelism: int, group=None):
    """This rank's place in the 2-D (graph x model) layout of ``group``'s
    ranks (the counterpart of JAX's ``hybrid_mesh``): (graph_group,
    model_group, g). Ranks are graph-major, as JAX reshapes its
    devices to (n // M, M): rank r is (g, m) = divmod(r, M); the graph
    group of m is {g M + m for every g} (the ranks that exchange halos
    on column block m), the model group of g is {g M, ..., g M + M - 1}
    (the ranks that split the features of vertex block g).

    Collective: every rank of ``group`` calls it, since every rank must
    create every subgroup, in one order, even those it is not in."""
    n = dist.get_world_size(group)
    if model_parallelism < 1 or n % model_parallelism:
        raise ValueError(f"model parallelism {model_parallelism} does not "
                         f"divide {n} ranks")
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    me = dist.get_rank(group)
    gdim, mdim = n // model_parallelism, model_parallelism
    g, m = divmod(me, mdim)
    graph_group = model_group = None
    for j in range(mdim):
        sub = dist.new_group([ranks[i * mdim + j] for i in range(gdim)])
        if j == m:
            graph_group = sub
    for i in range(gdim):
        sub = dist.new_group([ranks[i * mdim + j] for j in range(mdim)])
        if i == g:
            model_group = sub
    return graph_group, model_group, g


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(rank: int, world_size: int, *, port: int, backend: str,
               device=None, timeout_s: float = 300.0) -> None:
    """Join the process group at ``tcp://127.0.0.1:<port>`` as ``rank`` of
    ``world_size``; with nccl, ``device`` is this rank's card."""
    kw = {}
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(device)
        kw["device_id"] = torch.device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _rank_main(rank, n, port, backend, device, fn, args, results):
    try:
        initialize(rank, n, port=port, backend=backend,
                   device=rank_device(rank, device) if backend == "nccl"
                   else None)
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        # the parent reports the traceback and fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, n: int, *args, device: str = "cpu", backend: str | None = None,
           timeout_s: float | None = 600.0) -> list:
    """``fn(rank, n, *args)`` in ``n`` spawned ranks, each inside the
    process group (``backend`` by default ``choose_backend``); returns
    the ranks' results in rank order. ``fn`` and its arguments and result
    must pickle (pass numpy arrays, not CUDA tensors). Raises if a rank
    raises, exits without a result or the whole launch outlasts
    ``timeout_s`` (None: no limit); every rank is ended before it
    returns."""
    backend = backend or choose_backend(n, device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, backend, device, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    got, errors = {}, {}
    grace = None    # once a rank failed: how long the others may still report
    try:
        while len(got) + len(errors) < n:
            if grace is not None and time.monotonic() > grace:
                break
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if grace is not None:
                    continue
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch of {n} ranks outlasted {timeout_s} s; "
                        f"results from ranks {sorted(got)}") from None
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died (its report, if any, may still be in
                    # the queue), and its peers wait on it
                    grace = time.monotonic() + _GRACE_S
                continue
            if ok:
                got[rank] = out
            else:
                errors[rank] = out
                grace = grace or time.monotonic() + _GRACE_S
        if grace is not None:
            for r, p in enumerate(procs):
                if r not in got and r not in errors and p.exitcode:
                    errors[r] = f"exited with code {p.exitcode} and no result"
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"rank {r}: {e}" for r, e in sorted(errors.items())))
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
    return [got[r] for r in range(n)]
