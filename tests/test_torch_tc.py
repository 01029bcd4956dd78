"""The port's triangle counting (``graphaibench_tpu_torch/analytics/tc.py``,
the kernel K9 ``tc_count`` of ``csrc/tc_count.cu`` with its wrapper and
plain version in ``ops/tc_count.py``) and the DAG orientation it runs on
(``graph/transforms.py::orientation``, ``native.orientation``), held against
the JAX package on the CPU.

Graphs are built by each package's own generators from the same parameters
and held equal here. Counts are integers and must be equal: the port's
against the JAX package's and the serial verifier's. On the CPU
``tc_count`` takes its plain version, the JAX package's compare-all; the
kernel's arithmetic (its blocks, classes and tasks, the destination's
hash table, the run of the sources' rows and the probes or searches in the
destination's row, over ``dag_edges``'s layout) is emulated in numpy from the constants of its
source, and the kernel itself runs on the card in ``chip_smoke.py``'s
analytics phase and in the test marked ``cuda``.
"""

import re

import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import tc as JTC
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch import native as tnative
from graphaibench_tpu_torch.analytics import tc as TC
from graphaibench_tpu_torch.analytics import triangle_count
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import tc_count as K9
from test_torch_sampler import jax_native  # noqa: F401

torch.set_num_threads(2)

_SOURCE = (_build.CSRC / "tc_count.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SOURCE).group(1))
CLASSES = int(re.search(r"constexpr int kClasses = (\d+);", _SOURCE).group(1))
SLOTS = int(re.search(r"constexpr int kSlots = (\d+);", _SOURCE).group(1))
HASH_MUL = int(re.search(r"constexpr uint32_t kHashMul = (0x[0-9A-Fa-f]+)u;",
                         _SOURCE).group(1), 16)
# class c's log2 lanes, from the kernel's dispatch
LG = [int(m) for m in re.findall(r"cnt = count_tasks<(\d+)>\(", _SOURCE)]
assert LG == [5 - c for c in range(CLASSES)]


def _unsorted(gen, tr, csr):
    """rmat(9, 8) with every row's neighbours in a seeded random order."""
    g = gen.rmat(9, 8, seed=1)
    col = g.col_idx.copy()
    rng = np.random.default_rng(3)
    for v in range(g.nv):
        lo, hi = g.row_ptr[v], g.row_ptr[v + 1]
        col[lo:hi] = rng.permutation(col[lo:hi])
    return csr.CSRGraph(row_ptr=g.row_ptr.copy(), col_idx=col)


def _star_cycle(gen, tr, csr):
    """A cycle of 12 and a star of 9 leaves: edges, no triangle."""
    cyc = np.arange(12)
    src = np.r_[cyc, np.zeros(9, np.int64) + 12]
    dst = np.r_[(cyc + 1) % 12, np.arange(13, 22)]
    return tr.symmetrize(csr.from_edges(src, dst, 22))


GRAPHS = {
    "uniform": lambda gen, tr, csr: gen.uniform_random(150, 500, seed=9),
    "rmat8": lambda gen, tr, csr: gen.rmat(8, 8, seed=4),
    "rmat12": lambda gen, tr, csr: gen.rmat(12, 16, seed=2),
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 9),
    "no_triangles": _star_cycle,
    "unsorted": _unsorted,
}

_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.row_ptr, j.row_ptr)
        assert np.array_equal(t.col_idx, j.col_idx)
        _CACHE[name] = (t, j)
    return _CACHE[name]


def _same_csr(a, b):
    assert a.row_ptr.dtype == b.row_ptr.dtype
    assert a.col_idx.dtype == b.col_idx.dtype
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col_idx, b.col_idx)


# ---- orientation -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orientation_bit_equal_numpy_route(name):
    g, jg = _pair(name)
    assert g.ne < 1 << 18
    _same_csr(T.orientation(g), JT.orientation(jg))


def test_orientation_bit_equal_native_route(jax_native):
    """rmat(14, 16) crosses 2^18 edges: both packages take their C++
    orientation, and the numpy route gives the same DAG."""
    g, jg = tgen.rmat(14, 16, seed=0), jgen.rmat(14, 16, seed=0)
    assert g.ne >= 1 << 18 and tnative.available()
    dag = T.orientation(g)
    _same_csr(dag, JT.orientation(jg))
    src, dst = g.coo()
    deg = g.degrees()
    keep = (deg[dst] > deg[src]) | ((deg[dst] == deg[src]) & (dst > src))
    _same_csr(dag, tcsr.from_edges(src[keep], dst[keep], g.nv,
                                   sort_neighbors=False))
    rp, ci = tnative.orientation(g.row_ptr, g.col_idx)
    jrp, jci = jax_native.orientation(jg.row_ptr, jg.col_idx)
    assert np.array_equal(rp, jrp) and np.array_equal(ci, jci)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_degree_histogram_equals_jax(name):
    g, jg = _pair(name)
    for bins in (0, 40):
        a, b = T.degree_histogram(g, bins), JT.degree_histogram(jg, bins)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the solver ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_count_matches_jax_and_serial(name):
    g, jg = _pair(name)
    n = triangle_count(g, device="cpu")
    assert type(n) is int
    assert n == JTC.triangle_count(jg)
    assert n == TV.triangle_count_serial(T.orientation(g))
    if name == "no_triangles":
        assert g.ne > 0 and n == 0
    # a second call is served from the cached device state
    assert triangle_count(g, device="cpu") == n


def test_unsorted_rows_are_sorted_before_the_count():
    """The DAG of a graph with unsorted rows keeps them unsorted (as the
    JAX package's does); the state K9 reads has them sorted."""
    g, _ = _pair("unsorted")
    dag = T.orientation(g)
    assert not dag.has_sorted_neighbors()
    state = TC._tc_device_state(g, "cpu")
    ci, rp = state.col_idx.numpy(), state.row_ptr.numpy()
    for v in range(g.nv):
        row = ci[rp[v]:rp[v + 1]]
        assert np.all(np.diff(row) >= 0)
        assert np.array_equal(row, np.sort(dag.neighbors(v)))


def test_state_cache_is_keyed_by_identity_and_device():
    a, _ = _pair("rmat8")
    b = tgen.rmat(8, 8, seed=4)          # equal arrays, another object
    sa = TC._tc_device_state(a, "cpu")
    assert TC._tc_device_state(a, "cpu") is sa
    assert TC._tc_device_state(b, "cpu") is not sa
    # another device, by its name: the layout is built on the device, so
    # the name is one that runs here
    assert TC._tc_device_state(a, "cpu:0") is not sa


# ---- the plain version against the JAX program -----------------------------

@pytest.mark.parametrize("name", ["uniform", "rmat8", "rmat12", "unsorted"])
def test_pack_padded_and_count_group_equal_jax(name):
    """``_pack_padded`` and ``count_group_plain`` against the JAX
    package's ``_pack_padded`` and ``_count_group`` on the same chunk: a
    seeded draw of DAG edges, some marked invalid, at a narrow and at the
    full width."""
    g, jg = _pair(name)
    dag, jdag = T.orientation(g), JT.orientation(jg)
    sentinel = dag.nv + 1
    nbr, deg = TC._pack_padded(dag, sentinel)
    jnbr, jdeg = JTC._pack_padded(jdag, sentinel)
    assert nbr.dtype == jnbr.dtype and np.array_equal(nbr, jnbr)
    assert np.array_equal(deg, jdeg)
    src, dst = dag.coo()
    rng = np.random.default_rng(7)
    pick = rng.integers(0, dag.ne, 64)
    valid = rng.random(64) < 0.8
    for wa in (8, nbr.shape[1]):
        got = K9.count_group_plain(
            torch.from_numpy(nbr), torch.from_numpy(src[pick]),
            torch.from_numpy(dst[pick]), torch.from_numpy(valid), wa)
        want = JTC._count_group(jnbr, src[pick], dst[pick], valid, wa=wa)
        assert int(got) == int(want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tc_count_plain_equals_the_serial_count(name):
    g, _ = _pair(name)
    state = TC._tc_device_state(g, "cpu")
    want = TV.triangle_count_serial(T.orientation(g))
    assert int(K9.tc_count_plain(state)) == want
    assert int(K9.tc_count(state)) == want


# ---- the kernel's layout and arithmetic ------------------------------------

def check_task_layout(state, src_in, dst_in) -> None:
    """The kernel's layout of the edges (src_in, dst_in): every edge with
    two non-empty rows exactly once, the others left out; tasks of at most
    TASK_EDGES edges of one destination, a destination's edges cut every
    TASK_EDGES from its first in their given order; the tasks by class,
    each within its class's bounds on the ids it streams (its sources'
    rows), and by destination inside a class."""
    rp = state.row_ptr.numpy().astype(np.int64)
    deg = np.diff(rp)
    src, dst = state.src.numpy(), state.dst.numpy()
    tasks = state.tasks.numpy().astype(np.int64)
    start = state.class_start
    assert len(start) == CLASSES + 1 and start[0] == 0
    assert list(start) == sorted(start) and start[-1] == len(tasks) - 1
    assert tasks[0] == 0 and tasks[-1] == len(src)
    assert np.all(np.diff(tasks) >= 1)
    assert np.all(np.diff(tasks) <= K9.TASK_EDGES)
    src_in, dst_in = np.asarray(src_in), np.asarray(dst_in)
    both = (deg[src_in] > 0) & (deg[dst_in] > 0)
    got = sorted(zip(src.tolist(), dst.tolist()))
    assert got == sorted(zip(src_in[both].tolist(), dst_in[both].tolist()))
    # each destination's edges, in their given order, cut into runs of
    # TASK_EDGES: the tasks hold exactly those runs
    runs = {}
    for u, v in zip(src_in[both].tolist(), dst_in[both].tolist()):
        runs.setdefault(v, []).append(u)
    want_tasks = sorted((v, tuple(us[i:i + K9.TASK_EDGES]))
                        for v, us in runs.items()
                        for i in range(0, len(us), K9.TASK_EDGES))
    bounds = (np.inf, *K9.CLASS_WORK, 0)
    seen = []
    for c in range(CLASSES):
        vs = []
        for t in range(start[c], start[c + 1]):
            a, b = tasks[t], tasks[t + 1]
            assert np.all(dst[a:b] == dst[a])
            work = deg[src[a:b]].sum()
            assert bounds[c + 1] < work <= bounds[c]
            vs.append(dst[a])
            seen.append((int(dst[a]), tuple(src[a:b].tolist())))
        assert vs == sorted(vs)
    assert sorted(seen) == want_tasks


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dag_edges_orders_the_edges_by_lane_group(name):
    """Every DAG edge with two non-empty rows is counted once, in a task of
    its destination whose class follows the ids the task streams; the
    others are left out."""
    g, _ = _pair(name)
    state = TC._tc_device_state(g, "cpu")
    rp = state.row_ptr.numpy().astype(np.int64)
    dsrc = np.repeat(np.arange(state.nv), np.diff(rp))
    check_task_layout(state, dsrc, state.col_idx.numpy())


def _hash(x: int, bits: int) -> int:
    return ((int(x) * HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


def emulate_kernel(state) -> int:
    """tc_count_kernel in numpy: the host entry's block prefix, each
    block's class and groups, each group's task: its destination's row
    hashed when it fits the group's slots (linear probing, a repeated id an
    entry of its own), the task's edges a chunk of lanes at a time, the
    lanes' prefix of their sources' row lengths, each id of the run mapped
    to its edge by the ballot, the reduction and the popcounts, and probed
    in the table, or found in the row by the fixed-step lower bound and the
    run of equal ids."""
    rp = state.row_ptr.numpy().astype(np.int64)
    col = state.col_idx.numpy()
    src, dst = state.src.numpy(), state.dst.numpy()
    tasks = state.tasks.numpy().astype(np.int64)
    cs = state.class_start
    block_start, blocks = [], 0
    for c in range(CLASSES):
        block_start.append(blocks)
        per_block = THREADS >> LG[c]
        blocks += -(-(cs[c + 1] - cs[c]) // per_block)
    block_start.append(blocks)
    task_seen = np.zeros(len(tasks) - 1, np.int64)
    edge_seen = np.zeros(len(src), np.int64)
    total = 0
    for blk in range(blocks):
        c = 0
        while c + 1 < CLASSES and blk >= block_start[c + 1]:
            c += 1
        lanes = 1 << LG[c]
        for group in range(THREADS // lanes):
            t = cs[c] + (blk - block_start[c]) * (THREADS // lanes) + group
            if t >= cs[c + 1]:
                continue
            task_seen[t] += 1
            e0, e1 = tasks[t], tasks[t + 1]
            v = dst[e0]
            b = col[rp[v]:rp[v + 1]]
            nb = len(b)
            bits = 0
            if nb <= SLOTS * lanes // 2:
                bits = min(int(4 * nb - 1).bit_length(), LG[c] + 4)
                table = np.full(1 << bits, -1, np.int64)
                assert 2 * nb <= len(table)
                for x in b:
                    p = _hash(x, bits)
                    while table[p] != -1:
                        p = (p + 1) & ((1 << bits) - 1)
                    table[p] = x
            top = 1 << (nb.bit_length() - 1) if nb else 0
            for ch in range(e0, e1, lanes):
                e = np.arange(ch, ch + lanes)
                live = e < e1
                edge_seen[e[live]] += 1
                u = src[np.minimum(e, e1 - 1)]
                ub = np.where(live, rp[u], 0)
                un = np.where(live, rp[u + 1] - rp[u], 0)
                incl = np.cumsum(un)
                excl = incl - un
                for base in range(0, incl[-1], lanes):
                    begun = int(((un > 0) & (excl <= base)).sum())
                    starts = 0
                    for kk in range(lanes):
                        if un[kk] > 0 and base < excl[kk] < base + lanes:
                            starts |= 1 << int(excl[kk] - base)
                    for gl in range(lanes):
                        i = base + gl
                        if i >= incl[-1]:
                            continue
                        k = begun - 1 + bin(starts & ((2 << gl) - 1)).count(
                            "1")
                        assert excl[k] <= i < incl[k]
                        x = col[ub[k] + i - excl[k]]
                        if bits:
                            p = _hash(x, bits)
                            while table[p] != -1:
                                total += table[p] == x
                                p = (p + 1) & ((1 << bits) - 1)
                            continue
                        p, s = 0, top
                        while s > 0:
                            if p + s <= nb and b[p + s - 1] < x:
                                p += s
                            s >>= 1
                        while p < nb and b[p] == x:
                            total += 1
                            p += 1
    assert np.all(task_seen == 1) and np.all(edge_seen == 1)
    return int(total)


def _count_by_rows(state) -> int:
    """The sum over the counted edges of |N+(u) ∩ N+(v)| with
    multiplicity, in numpy."""
    rp = state.row_ptr.numpy().astype(np.int64)
    col = state.col_idx.numpy()
    total = 0
    for u, v in zip(state.src.numpy(), state.dst.numpy()):
        a, b = col[rp[u]:rp[u + 1]], col[rp[v]:rp[v + 1]]
        total += int((a[:, None] == b[None, :]).sum())
    return total


@pytest.mark.parametrize("name", ["uniform", "rmat8", "edgeless",
                                  "no_triangles", "unsorted"])
def test_kernel_arithmetic_emulated_gives_jax_count(name):
    g, jg = _pair(name)
    assert emulate_kernel(TC._tc_device_state(g, "cpu")) == \
        JTC.triangle_count(jg)


def test_repeated_ids_count_with_their_multiplicity():
    """A DAG with a repeated neighbour: compare-all counts each pair of
    equal ids, and so do the plain version and the kernel's search."""
    dag = tcsr.CSRGraph(row_ptr=np.array([0, 3, 5, 5]),
                        col_idx=np.array([1, 2, 2, 2, 2], np.int32))
    state = K9.dag_edges(dag.row_ptr, dag.col_idx, device="cpu")
    # edges 0->1 (rows {1,2,2} and {2,2}: 2 * 2) and 0->2, 0->2 (row 2 is
    # empty, left out)
    assert int(K9.tc_count_plain(state)) == 4
    assert emulate_kernel(state) == 4
    jdag = jcsr.CSRGraph(row_ptr=dag.row_ptr, col_idx=dag.col_idx)
    nbr, _ = JTC._pack_padded(jdag, 4)
    src, dst = jdag.coo()
    assert int(JTC._count_group(nbr, src, dst, np.ones(5, bool), wa=3)) == 4


def _wide_dag():
    """A DAG whose rows 100 (298 ids) and 101 (69 ids) are wider than some
    groups' tables: the edges into 100 make three tasks of class 0 (32
    lanes, 512 slots: rows of up to 256 ids hashed) and one of class 2 (8
    lanes, 128 slots), those into 101 one task of class 0 and one of class
    2; ids repeated in both rows of some edges, each row sorted."""
    rng = np.random.default_rng(6)
    rows = {100: sorted(list(range(102, 400)) + [150]),
            101: list(range(102, 171))}
    for u in range(100):
        rows[u] = sorted(rng.choice(np.arange(102, 400), 10, replace=False)
                         .tolist() + [100] + ([101] if u < 32 else []))
    rows[5] = sorted(rows[5] + [150, 150])
    for u in range(400, 410):
        rows[u] = [101, 150]
    nv = 410
    rp = np.r_[0, np.cumsum([len(rows.get(v, [])) for v in range(nv)])]
    col = np.concatenate([rows.get(v, []) for v in range(nv)]).astype(
        np.int32)
    return rp, col


def test_a_destination_wider_than_its_table_is_searched_in_place():
    rp, col = _wide_dag()
    state = K9.dag_edges(rp, col, device="cpu")
    dsrc = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    check_task_layout(state, dsrc, col)
    tasks = state.tasks.numpy()
    dst = state.dst.numpy()
    deg = np.diff(rp)
    wide = {(c, int(dst[tasks[t]])) for c in range(CLASSES)
            for t in range(state.class_start[c], state.class_start[c + 1])
            if deg[dst[tasks[t]]] > SLOTS << LG[c] >> 1}
    assert wide == {(0, 100), (2, 100), (2, 101)}
    want = _count_by_rows(state)
    assert want > 0
    assert emulate_kernel(state) == want
    assert int(K9.tc_count_plain(state)) == want


def test_edges_given_out_of_order_are_laid_out_by_destination():
    """edges_between sorts the edges by destination first (stably), and the
    count does not change."""
    g, _ = _pair("rmat8")
    dag = T.orientation(g)
    src, dst = dag.coo()
    perm = np.random.default_rng(4).permutation(len(src))
    rp = torch.from_numpy(dag.row_ptr.astype(np.int32))
    col = torch.from_numpy(dag.col_idx.astype(np.int32))
    state = K9.edges_between(rp, col, torch.from_numpy(src[perm]),
                             torch.from_numpy(dst[perm]), id_bound=dag.nv)
    check_task_layout(state, src[perm], dst[perm])
    assert emulate_kernel(state) == JTC.triangle_count(_pair("rmat8")[1])


def test_wrapper_refuses_other_devices_and_types():
    state = TC._tc_device_state(_pair("rmat8")[0], "cpu")
    meta = K9.DagEdges(**{**state.__dict__, "src": state.src.to("meta"),
                          "dst": state.dst.to("meta"),
                          "row_ptr": state.row_ptr.to("meta"),
                          "col_idx": state.col_idx.to("meta"),
                          "tasks": state.tasks.to("meta")})
    with pytest.raises(ValueError, match="cpu or cuda"):
        K9.tc_count(meta)
    bad = K9.DagEdges(**{**state.__dict__, "src": state.src.long()})
    with pytest.raises(ValueError, match="int32"):
        K9.tc_count(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_matches_plain_on_cuda(name):
    """The kernel against its plain version on the card (run at rmat19 by
    chip_smoke.py's analytics phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: tc_count's kernel has no CPU mode")
    g, _ = _pair(name)
    want = TV.triangle_count_serial(T.orientation(g))
    assert int(K9.tc_count(TC._tc_device_state(g, "cuda"))) == want
    assert triangle_count(g, device="cuda") == want
