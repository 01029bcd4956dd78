"""The port's CGR decode on the device (``graphaibench_tpu_torch/compress/
cgr_device.py``, the kernels K12 of ``csrc/cgr_decode.cu`` with their
wrappers and plain versions in ``ops/cgr_decode.py``), held against the JAX
package's ``cgr_device.py`` and the original CSR on the CPU.

All of it is int32 and must be exact. On the CPU each wrapper takes its
plain version; each plain pass is held against the JAX pass it replaces on
the same lanes (``_headers``, ``_counts``, ``_residual_pass``,
``_interval_pass``), and the whole decode against JAX's
``cgr_decode_device`` (jit on the JAX CPU backend) and the graph. The
kernels' source is compiled here with g++ against a header that emulates
the CUDA intrinsics it uses and runs its blocks one thread after another,
and held against the plain versions; the kernels themselves run on the card
in the test marked ``cuda`` and in ``chip_smoke.py``'s ``compress`` phase.
The graphs and configurations are those of ``tests/test_compress.py``
(:392-545).
"""

import shutil
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.compress import cgr as jcgr
from graphaibench_tpu.compress import cgr_device as JCD
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch.compress import cgr as tcgr
from graphaibench_tpu_torch.compress import cgr_device as CD
from graphaibench_tpu_torch.compress import device_decode as DD
from graphaibench_tpu_torch.compress import hybrid as thybrid
from graphaibench_tpu_torch.compress.unary import (
    BitWriter,
    int_2_nat,
    write_gamma,
)
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import cgr_decode as K12
from test_torch_compress import _runs
from test_torch_device_decode import EMULATION as DEVICE_EMULATION
from test_torch_device_decode import build_emulated

torch.set_num_threads(2)

GRAPHS = {
    "rmat9": lambda gen, tr, csr: tr.sort_and_clean(gen.rmat(9, 8, seed=1)),
    "uniform": lambda gen, tr, csr: tr.sort_and_clean(
        gen.uniform_random(200, 600, seed=2)),
    "runs": _runs,
    "small": lambda gen, tr, csr: tr.sort_and_clean(
        gen.uniform_random(60, 180, seed=3)),
}
# tests/test_compress.py:406-407 and :450-451
PLAIN_CONFIGS = {"default": {}, "zeta3": dict(zeta_k=3),
                 "byte": dict(alignment="byte"), "word": dict(alignment="word"),
                 "add_degree": dict(add_degree=True),
                 "seg64": dict(res_seg_len=64), "zeta1": dict(zeta_k=1)}
INTERVAL_CONFIGS = {"itv64": {}, "add_degree": dict(add_degree=True),
                    "itv128": dict(itv_seg_len=128),
                    "min2": dict(min_itv_len=2), "zeta3": dict(zeta_k=3),
                    "byte": dict(alignment="byte")}
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.col_idx, j.col_idx)
        _CACHE[name] = (t, j)
    return _CACHE[name]


def _cfg(kw, interval=False):
    kw = ({"use_interval": True, "itv_seg_len": 64, **kw} if interval
          else {"use_interval": False, **kw})
    return tcgr.CgrConfig(**kw), jcgr.CgrConfig(**kw)


def _streams(name, kw, interval=False):
    g, jg = _pair(name)
    tc, jc = _cfg(kw, interval)
    t, j = tcgr.encode_graph(g, tc), jcgr.encode_graph(jg, jc)
    assert t.data == j.data
    return g, t, j


def _same(got, g, what=""):
    np.testing.assert_array_equal(got.row_ptr, g.row_ptr, err_msg=what)
    np.testing.assert_array_equal(got.col_idx, g.col_idx, err_msg=what)


# ---- the whole decode ------------------------------------------------------

@pytest.mark.parametrize("cfg", sorted(PLAIN_CONFIGS))
@pytest.mark.parametrize("name", ["rmat9", "uniform"])
def test_decode_equals_the_graph(name, cfg):
    g, t, _ = _streams(name, PLAIN_CONFIGS[cfg])
    got = CD.cgr_decode_device(t, device="cpu")
    _same(got, g, cfg)
    assert got.col_idx.dtype == np.int32 and got.row_ptr.dtype == np.int64


@pytest.mark.parametrize("cfg", sorted(INTERVAL_CONFIGS))
@pytest.mark.parametrize("name", ["runs", "rmat9"])
def test_interval_decode_equals_the_graph(name, cfg):
    g, t, _ = _streams(name, INTERVAL_CONFIGS[cfg], interval=True)
    prep = CD.cgr_device_prep(t, device="cpu")
    if name == "runs":
        assert prep["n_itv"] > 0
    row_ptr, col = CD.cgr_device_run(prep)
    assert isinstance(col, torch.Tensor) and col.device.type == "cpu"
    _same(tcsr.CSRGraph(row_ptr=row_ptr, col_idx=col.numpy()), g, cfg)


@pytest.mark.parametrize("name,cfg,interval", [
    ("rmat9", "default", False), ("uniform", "zeta3", False),
    ("rmat9", "add_degree", False), ("runs", "itv64", True),
    ("runs", "zeta3", True)])
def test_decode_equals_jax_device_decode(name, cfg, interval):
    configs = INTERVAL_CONFIGS if interval else PLAIN_CONFIGS
    g, t, j = _streams(name, configs[cfg], interval)
    got = CD.cgr_decode_device(t, device="cpu")
    want = JCD.cgr_decode_device(j)
    _same(got, g)
    np.testing.assert_array_equal(got.row_ptr, np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx, np.asarray(want.col_idx))


def test_small_segments_decode_or_raise_as_jax():
    """res_seg_len 32 and 64 and itv_seg_len 32 decode on the small-id
    graph (every code fits its slot); tests/test_compress.py:501-545."""
    g, _ = _pair("small")
    for kw in (dict(res_seg_len=32), dict(res_seg_len=64),
               dict(use_interval=True, itv_seg_len=32)):
        cg = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
        _same(CD.cgr_decode_device(cg, device="cpu"), g, str(kw))


def _oversized(gen, tr, csr):
    """Vertex 0's three residuals each need a gamma of 17 bits or more,
    over a 16-bit slot: each forms a segment, and the first, closed, spans
    two slots (tests/test_compress.py:531-545 at a smaller scale)."""
    src = np.asarray([0, 0, 0])
    dst = np.asarray([1 << 9, (1 << 9) + (1 << 8), 1 << 10])
    return tr.sort_and_clean(csr.from_edges(src, dst, 1 << 11))


OVERSIZED = dict(res_seg_len=16, zeta_k=1)


def test_oversized_multi_slot_segment_raises_in_both():
    g, jg = _oversized(tgen, T, tcsr), _oversized(jgen, JT, jcsr)
    cfg = OVERSIZED
    t = tcgr.encode_graph(g, tcgr.CgrConfig(**cfg))
    j = jcgr.encode_graph(jg, jcgr.CgrConfig(**cfg))
    assert t.data == j.data
    _same(tcgr.decode_graph(t), g, "host decode stays exact")
    with pytest.raises(CD.StreamRefused, match="device CGR decode"):
        CD.cgr_decode_device(t, device="cpu")
    with pytest.raises(ValueError):
        JCD.cgr_decode_device(j)


def test_closed_segment_check_ignores_the_last_segment():
    """A closed segment (not a vertex's last) whose codes ran past its slot
    is refused; the last segment, unpadded, may run on."""
    seg_start = np.asarray([0, 32, 100], np.int64)
    lane_k = np.asarray([0, 1, 0], np.int64)
    lane_v = np.asarray([0, 0, 1])
    nsegs = np.asarray([2, 1])
    fits = np.asarray([32, 90, 300])
    CD._check_closed_segments_fit(fits, seg_start, lane_k, nsegs, lane_v, 32,
                                  "residual")
    with pytest.raises(CD.StreamRefused,
                       match="oversized multi-slot residual"):
        CD._check_closed_segments_fit(fits + [1, 0, 0], seg_start, lane_k,
                                      nsegs, lane_v, 32, "residual")


@pytest.mark.parametrize("kw", [dict(res_seg_len=0), dict(res_seg_len=3)])
def test_refused_streams_raise_in_both(kw):
    g = T.sort_and_clean(tgen.uniform_random(50, 150, seed=0))
    jg = JT.sort_and_clean(jgen.uniform_random(50, 150, seed=0))
    t = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
    j = jcgr.encode_graph(jg, jcgr.CgrConfig(**kw))
    with pytest.raises(CD.StreamRefused, match="device CGR decode"):
        CD.cgr_decode_device(t, device="cpu")
    with pytest.raises(ValueError):
        JCD.cgr_decode_device(j)


def test_positions_past_int32_are_refused():
    g, _ = _pair("small")
    cg = tcgr.encode_graph(g)
    big = tcgr.CompressedGraph(nv=cg.nv, ne=cg.ne,
                               offsets=cg.offsets + (1 << 31), data=cg.data,
                               cfg=cg.cfg)
    with pytest.raises(CD.StreamRefused, match="int32"):
        CD.cgr_device_prep(big, device="cpu")


def test_interval_lengths_below_the_minimum_are_refused():
    """A crafted interval stream: two vertices, one interval each, whose
    lengths still sum to ne but the first wraps to -4 in int32 (a 63-bit
    gamma code). The prep refuses it before any pass writes: its rows'
    slots would run backwards and out of ``col``."""
    cfg = tcgr.CgrConfig(use_interval=True)
    w, offsets = BitWriter(), [0]
    for v, (left, x) in enumerate([(1, (1 << 32) - 8), (2, 8)]):
        # one interval segment of one (left, len - min_itv_len) pair, then
        # one residual segment of count 0
        for val in (0, 1, int_2_nat(left - v), x, 0, 0):
            write_gamma(w, val)
        offsets.append(w.bit_length)
    cg = tcgr.CompressedGraph(nv=2, ne=8, cfg=cfg, data=w.getvalue(),
                              offsets=np.asarray(offsets, np.int64))
    with pytest.raises(CD.StreamRefused, match="interval below 4 ids"):
        CD.cgr_device_prep(cg, device="cpu")


@pytest.mark.parametrize("interval", [False, True])
def test_empty_graph_decodes_to_the_empty_csr(interval):
    empty = tcsr.CSRGraph(row_ptr=np.zeros(9, np.int64),
                          col_idx=np.zeros(0, np.int32))
    cg = tcgr.encode_graph(empty, tcgr.CgrConfig(use_interval=interval,
                                                 add_degree=True))
    got = CD.cgr_decode_device(cg, device="cpu")
    assert got.nv == 8 and got.ne == 0


# ---- each plain pass against the JAX pass ----------------------------------

def _jax_views(data: bytes):
    pad = (-len(data)) % 4 + 16
    words = jnp.asarray(np.frombuffer(data + b"\x00" * pad, dtype=">u4")
                        .astype(np.uint32))
    return JCD._pairs(words), JCD._quads(words)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("name,cfg", [("rmat9", "default"),
                                      ("rmat9", "add_degree"),
                                      ("runs", "zeta1")])
def test_header_and_count_passes_equal_jax(name, cfg):
    """``cgr_gamma`` (HEADER or HEADER_DEG; COUNT) against ``_headers`` and
    ``_counts`` on every vertex and every segment."""
    _, t, _ = _streams(name, PLAIN_CONFIGS[cfg])
    pairs, _ = _jax_views(t.data)
    stream = K12.stream_tensor(t.data, "cpu")
    bit_off = (np.asarray(t.offsets[:t.nv]) * t.cfg.unit_bits).astype(np.int32)
    kind = K12.HEADER_DEG if t.cfg.add_degree else K12.HEADER
    ns, base = K12.cgr_gamma(stream, _i32(bit_off), kind)
    jns, jbase = JCD._headers(pairs, jnp.asarray(bit_off), t.cfg.add_degree)
    assert np.array_equal(ns.numpy(), np.asarray(jns))
    assert np.array_equal(base.numpy(), np.asarray(jbase))
    _, _, seg_start = CD._lanes(ns.numpy().astype(np.int64), base.numpy(),
                                t.cfg.res_seg_len)
    cnt, nxt = K12.cgr_gamma(stream, _i32(seg_start), K12.COUNT)
    jcnt, jnxt = JCD._counts(pairs, jnp.asarray(seg_start.astype(np.int32)),
                             jnp.ones(len(seg_start), bool))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert np.array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("name,cfg", [("rmat9", "default"),
                                      ("rmat9", "zeta3"), ("uniform", "zeta1")])
def test_residual_pass_equals_jax(name, cfg):
    _, t, _ = _streams(name, PLAIN_CONFIGS[cfg])
    prep = CD.cgr_device_prep(t, device="cpu")
    _, quads = _jax_views(t.data)
    lanes = [prep[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    col, pfin = K12.cgr_residual(prep["stream"], *lanes, t.ne, t.cfg.zeta_k)
    jcol, jpfin = JCD._residual_pass(
        quads, *(jnp.asarray(x.numpy()) for x in lanes),
        jnp.zeros(t.ne, jnp.int32), t.cfg.zeta_k,
        int(prep["counts"].max()), t.ne)
    assert np.array_equal(col.numpy(), np.asarray(jcol))
    assert np.array_equal(pfin.numpy(), np.asarray(jpfin))


@pytest.mark.parametrize("cfg", ["itv64", "min2", "add_degree"])
def test_interval_pass_equals_jax(cfg):
    _, t, _ = _streams("runs", INTERVAL_CONFIGS[cfg], interval=True)
    _, quads = _jax_views(t.data)
    stream = K12.stream_tensor(t.data, "cpu")
    bit_off = (np.asarray(t.offsets[:t.nv]) * t.cfg.unit_bits).astype(np.int32)
    kind = K12.HEADER_DEG if t.cfg.add_degree else K12.HEADER
    ns, base = K12.cgr_gamma(stream, _i32(bit_off), kind)
    lane_v, _, seg_start = CD._lanes(ns.numpy().astype(np.int64),
                                     base.numpy(), t.cfg.itv_seg_len)
    cnt, data_p = K12.cgr_gamma(stream, _i32(seg_start), K12.COUNT)
    ibase = np.cumsum(cnt.numpy()) - cnt.numpy()
    n_itv = int(cnt.sum())
    lanes = (data_p, cnt, _i32(lane_v), _i32(ibase))
    left, length, pfin = K12.cgr_interval(stream, *lanes, n_itv,
                                          t.cfg.min_itv_len)
    jleft, jlen, jpfin = JCD._interval_pass(
        quads, *(jnp.asarray(x.numpy()) for x in lanes),
        jnp.zeros(n_itv, jnp.int32), jnp.zeros(n_itv, jnp.int32),
        t.cfg.min_itv_len, int(cnt.max()), n_itv)
    assert n_itv > 0
    assert np.array_equal(left.numpy(), np.asarray(jleft))
    assert np.array_equal(length.numpy(), np.asarray(jlen))
    assert np.array_equal(pfin.numpy(), np.asarray(jpfin))


def test_merge_plain_places_runs_between_residuals():
    """Two rows: [1, 9] with the interval 4..6, and [] with 10..11 and
    20..22; the residual buffer holds each row's residuals first."""
    res = _i32([1, 9, -1, -1, -1, -1, -1, -1, -1, -1])
    row_ptr = _i32([0, 5, 10])
    nres = _i32([2, 0])
    itv_ptr = _i32([0, 1, 3])
    left, length = _i32([4, 10, 20]), _i32([3, 2, 3])
    pre = _i32([0, 3, 5, 8])
    col = K12.cgr_merge(res, row_ptr, nres, itv_ptr, left, length, pre)
    assert col.tolist() == [1, 4, 5, 6, 9, 10, 11, 20, 21, 22]


def test_wrappers_refuse_bad_operands():
    stream = K12.stream_tensor(b"\xff" * 8, "cpu")
    pos = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K12.cgr_gamma(stream, pos.long(), K12.COUNT)
    with pytest.raises(ValueError, match="uint8"):
        K12.cgr_gamma(stream[:-3], pos, K12.COUNT)
    with pytest.raises(ValueError, match="kind"):
        K12.cgr_gamma(stream, pos, 7)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K12.cgr_gamma(stream.to("meta"), pos.to("meta"), K12.COUNT)
    with pytest.raises(ValueError, match="different lengths"):
        K12.cgr_residual(stream, pos, pos, pos, pos[:2], 4, 2)
    assert stream.numel() % 4 == 0 and stream.numel() >= 8 + 16


# ---- the kernels' source, emulated on the host -----------------------------

# the threaded emulation of tests/test_torch_device_decode.py (a block's
# threads as host threads meeting at __syncthreads, shared memory static,
# an asynchronous copy done at once), with the bit operations K12 uses
EMULATION = DEVICE_EMULATION + r"""
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const unsigned long long x = ((unsigned long long)b << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((x >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  const unsigned long long x = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((x << (s & 31)) >> 32);
}
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned s) {
  const unsigned long long x = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((x << (s > 32 ? 32 : s)) >> 32);
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
// one SM: cgr_gamma takes four positions a thread from 4 * 2048 of them
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The library of ``csrc/cgr_decode.cu`` built by g++ for the host,
    each launch ``k<<<grid, block, 0, s>>>(args)`` run block after block,
    a block's threads as host threads that meet at ``__syncthreads``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("cgr_emulated"),
                          "cgr_decode.cu", 4, EMULATION)


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The same library with cgr_residual's block spans cut down: 8 staged
    words and 64 collected ids a tile, so that a lane's codes leave the
    staged words and its ids the collected slots under the shipped
    tables."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("cgr_small"),
                          "cgr_decode.cu", 4, EMULATION,
                          {"kResWords": 8, "kResSlots": 64})


@pytest.fixture(scope="module")
def emulated_small_gamma(tmp_path_factory):
    """The same library with cgr_gamma's threads taking 3 positions each in
    every launch, so that a warp's last positions fall short of its 96."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("cgr_small_gamma"),
                          "cgr_decode.cu", 4, EMULATION,
                          {"kGammaPer": 3, "kResidentThreads": 0})


def _gamma_case(case):
    """(stream, positions, kind) of a cgr_gamma launch of the decode: the
    vertices' headers (HEADER, HEADER_DEG), every residual segment's count,
    the residual headers of an interval stream with degrees (0 where a
    vertex has no interval section: out of order), the counts of rmat13 in
    a random order and from the second on (not 16-byte aligned, a count not
    a multiple of 4)."""
    name, cfg, interval = {
        "header": ("rmat9", "default", False),
        "header_deg": ("rmat9", "add_degree", False),
        "count": ("rmat9", "default", False),
        "res_pos": ("runs", "add_degree", True),
    }.get(case, ("rmat13", "default", False))
    if name == "rmat13" and "rmat13" not in GRAPHS:
        GRAPHS["rmat13"] = lambda gen, tr, csr: tr.sort_and_clean(
            gen.rmat(13, 16, seed=4))
    _, t, _ = _streams(name, (INTERVAL_CONFIGS if interval
                              else PLAIN_CONFIGS)[cfg], interval)
    prep = CD.cgr_device_prep(t, device="cpu")
    stream = prep["stream"]
    if case in ("header", "header_deg"):
        return stream, prep["bit_off"], (K12.HEADER_DEG if t.cfg.add_degree
                                         else K12.HEADER)
    if case == "res_pos":
        ilanes = prep["itv_lanes"]
        _, _, ipfin = K12.cgr_interval(stream, *ilanes,
                                       prep["left"].numel(),
                                       t.cfg.min_itv_len)
        nsegs = np.bincount(ilanes[2].numpy(), minlength=t.nv)
        pos = CD.residual_header_pos(nsegs, ipfin.numpy())
        assert (np.diff(pos) < 0).any()
        return stream, _i32(pos), K12.HEADER
    seg = _i32(prep["seg_start"])
    if case == "count_shuffled":
        seg = seg[torch.from_numpy(np.random.default_rng(0).permutation(
            seg.numel()))].contiguous()
    elif case == "count_unaligned":
        m = seg.numel() - 1
        seg = seg[1:m if m % 4 == 0 else m + 1]
        assert seg.data_ptr() % 16 and seg.numel() % 4
    return stream, seg, K12.COUNT


@pytest.mark.parametrize("case", ["header", "header_deg", "count", "res_pos",
                                  "count_shuffled", "count_unaligned"])
def test_gamma_source_emulated_equals_plain(emulated, emulated_small_gamma,
                                            case):
    """cgr_gamma equals the plain version on each kind of launch: a
    position a thread below 8,192 positions (on the emulation's one SM),
    four a thread above, three a thread in every launch."""
    stream, pos, kind = _gamma_case(case)
    if case == "count_shuffled":
        assert pos.numel() >= 4 * 2048
    want = K12.cgr_gamma_plain(stream, pos, kind)
    for lib in (emulated, emulated_small_gamma):
        v, n = torch.full_like(pos, -7), torch.full_like(pos, -7)
        assert lib.gab_cgr_gamma(stream.data_ptr(), stream.numel() // 4,
                                 pos.data_ptr(), pos.numel(), kind,
                                 v.data_ptr(), n.data_ptr(), 0, None) == 0
        assert torch.equal(v, want[0]) and torch.equal(n, want[1])


def _emulated_merge(lib, args, tile_row, tile_slots: int):
    """``gab_cgr_merge`` of the emulated library on ``args`` (cgr_merge's
    operands) in tiles of ``tile_slots`` slots, the table built when
    ``tile_row`` is None."""
    ne = args[0].numel()
    if tile_row is None:
        tile_row = K12.merge_tile_rows(args[1], ne, tile_slots)
    col = torch.full_like(args[0], -1)
    assert lib.gab_cgr_merge(*(t.data_ptr() for t in args), args[2].numel(),
                             tile_row.data_ptr(), tile_row.numel() - 1,
                             tile_slots, ne, col.data_ptr(), 0, None) == 0
    return col


def _emulated_residual(lib, stream, lanes, ne, k, tiles=None, order=None):
    """``gab_cgr_residual`` of the emulated library on ``lanes``, under
    ``residual_tables``' tables when none are given; col starts zeroed, as
    the plain version's."""
    if tiles is None or order is None:
        t = K12.residual_tables(lanes[1])
        tiles, order = t["tiles"], t["order"]
    col = torch.zeros(ne, dtype=torch.int32)
    pf = torch.full_like(lanes[0], -1)
    assert lib.gab_cgr_residual(
        stream.data_ptr(), stream.numel() // 4,
        *(a.data_ptr() for a in lanes), lanes[0].numel(), tiles.data_ptr(),
        tiles.numel() - 1, order.data_ptr(), k, col.data_ptr(), ne,
        pf.data_ptr(), 0, None) == 0
    return col, pf


def _emulated_passes(lib, monkeypatch):
    """Route every wrapper through the emulated library and hold each call
    against the plain version on the same inputs."""
    words = lambda s: s.numel() // 4   # noqa: E731
    calls = {}

    def gamma(stream, pos, kind):
        v, n = torch.empty_like(pos), torch.empty_like(pos)
        assert lib.gab_cgr_gamma(stream.data_ptr(), words(stream),
                                 pos.data_ptr(), pos.numel(), kind,
                                 v.data_ptr(), n.data_ptr(), 0, None) == 0
        return v, n

    def residual(stream, dp, c, lv, b, ne, k, tiles=None, order=None):
        # the caller's tables, then tiles of a few lanes and few ids: a
        # lane's codes past the staged words, ids past the collected slots
        got = _emulated_residual(lib, stream, (dp, c, lv, b), ne, k,
                                 tiles, order)
        with mock.patch.multiple(K12, RESIDUAL_TILE_LANES=3,
                                 RESIDUAL_TILE_IDS=40):
            small = _emulated_residual(lib, stream, (dp, c, lv, b), ne, k)
        for a, b_ in zip(got, small):
            assert torch.equal(a, b_)
        return got

    def interval(stream, dp, c, lv, b, n_itv, m):
        lf = torch.empty(n_itv, dtype=torch.int32)
        ln, pf = torch.empty_like(lf), torch.empty_like(dp)
        assert lib.gab_cgr_interval(stream.data_ptr(), words(stream),
                                    dp.data_ptr(), c.data_ptr(), lv.data_ptr(),
                                    b.data_ptr(), dp.numel(), m,
                                    lf.data_ptr(), ln.data_ptr(),
                                    pf.data_ptr(), 0, None) == 0
        return lf, ln, pf

    def merge(*args, tile_row=None):
        # the prep's tiles, then tiles of 8 slots: boundaries inside
        # intervals and between a residual and the interval after it
        col = _emulated_merge(lib, args, tile_row, K12.MERGE_TILE_SLOTS)
        small = _emulated_merge(lib, args, None, 8)
        assert torch.equal(col, small)
        return col

    def checked(name, emu, plain):
        def run(*args, **tables):
            got, want = emu(*args, **tables), plain(*args)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b), name
            calls[name] = calls.get(name, 0) + 1
            return got
        return run

    for name, emu in (("cgr_gamma", gamma), ("cgr_residual", residual),
                      ("cgr_interval", interval), ("cgr_merge", merge)):
        monkeypatch.setattr(K12, name, checked(
            name, emu, getattr(K12, f"{name}_plain")))
    return calls


@pytest.mark.parametrize("name,cfg,interval", [
    ("rmat9", "default", False), ("rmat9", "zeta1", False),
    ("uniform", "word", False), ("rmat9", "add_degree", False),
    ("runs", "itv64", True), ("runs", "zeta3", True),
    ("runs", "add_degree", True)])
def test_kernel_source_emulated_equals_plain(emulated, monkeypatch, name,
                                             cfg, interval):
    """Every launch of a decode through the emulated kernels equals the
    plain version on the same inputs, and the decode gives the graph."""
    calls = _emulated_passes(emulated, monkeypatch)
    configs = INTERVAL_CONFIGS if interval else PLAIN_CONFIGS
    g, t, _ = _streams(name, configs[cfg], interval)
    _same(CD.cgr_decode_device(t, device="cpu"), g, cfg)
    assert calls["cgr_residual"] == 1
    assert calls.get("cgr_merge", 0) == (1 if interval else 0)


def test_kernel_source_emulated_on_a_stream_that_does_not_parse(emulated,
                                                                monkeypatch):
    """Reads at the wrong places (the oversized segment) stay inside the
    stream and give the plain version's values."""
    calls = _emulated_passes(emulated, monkeypatch)
    g = _oversized(tgen, T, tcsr)
    for kw in (OVERSIZED, dict(OVERSIZED, use_interval=True, itv_seg_len=16)):
        cg = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
        with pytest.raises(CD.StreamRefused, match="device CGR decode"):
            CD.cgr_decode_device(cg, device="cpu")
    assert calls["cgr_gamma"] >= 4


def _merge_operands(rows):
    """cgr_merge's operands for rows given as (residuals, [(left, len),
    ...]): the residual buffer holds each row's residuals first in its
    slots, the rest -1."""
    deg = [len(r) + sum(n for _, n in itv) for r, itv in rows]
    row_ptr = np.r_[0, np.cumsum(deg)]
    res = np.full(row_ptr[-1], -1)
    for (r, _), b in zip(rows, row_ptr):
        res[b:b + len(r)] = r
    itvs = [x for _, itv in rows for x in itv]
    lens = np.array([n for _, n in itvs], np.int64)
    return (_i32(res), _i32(row_ptr), _i32([len(r) for r, _ in rows]),
            _i32(np.r_[0, np.cumsum([len(itv) for _, itv in rows])]),
            _i32([lf for lf, _ in itvs]), _i32(lens),
            _i32(np.r_[0, np.cumsum(lens)]))


def test_merge_source_emulated_on_rows_of_every_shape(emulated):
    """The merge kernel against its plain version in tiles of 4, 8, 12, 32
    and 256 slots: a row of residuals only, a row of intervals only (one of
    700 ids, across many tiles), an empty row, rows mixing both with tile
    boundaries inside intervals and between a residual and the interval
    after it, 300 empty rows among rows of intervals, short rows that
    share a tile, and a row of 3,000 whose
    residuals and intervals alternate, so that a lane meets many of both
    in one row."""
    rng = np.random.default_rng(3)
    mixed = []
    for n, p in [(40, 0.3)] * 6 + [(3000, 0.02)]:
        ids = np.unique(rng.integers(0, 100 * n, n))
        itv, res, x = [], [], 0
        for v in ids:
            if rng.random() < p and v > x + 1:
                n = int(rng.integers(4, 30))
                itv.append((int(v), n))
                x = v + n + 1
            elif v > x:
                res.append(int(v))
                x = v + 1
        mixed.append((res, itv))
    rows = [(list(range(0, 900, 3)), []), ([], [(10, 700)]), ([], []),
            ([2, 9], [(4, 4)]), ([], [(1, 4), (6, 5), (20, 40)]),
            *[([], [])] * 300, ([100], []), ([3], [(5, 6)]), *mixed,
            ([7, 8], [])]
    args = _merge_operands(rows)
    want = K12.cgr_merge_plain(*args)
    assert sorted(set(want.tolist())) and (want >= 0).all()
    for slots in (4, 8, 12, 32, 256):
        assert torch.equal(_emulated_merge(emulated, args, None, slots),
                           want), slots


def test_merge_tile_rows():
    """The row holding each tile's first slot, empty rows skipped, then
    the last row."""
    row_ptr = _i32([0, 3, 3, 3, 10, 11, 20, 20])
    assert K12.merge_tile_rows(row_ptr, 20, 4).tolist() == [0, 3, 3, 5, 5,
                                                            6]
    assert K12.merge_tile_rows(row_ptr, 20, 256).tolist() == [0, 6]
    assert K12.merge_tile_rows(_i32([0]), 0).tolist() == [0]


def test_star_decodes_through_the_emulated_kernels(emulated, monkeypatch):
    """rmat9 joined to a star of 3,000 leaves numbered after the hub, in
    CGR with intervals in 64-bit segments: the hub's row is two intervals
    (every rmat9 vertex, then the leaves) and nothing else, the leaves'
    rows one residual each; every pass through the emulated kernels
    equals its plain version and the decode the graph."""
    calls = _emulated_passes(emulated, monkeypatch)
    g0 = tgen.rmat(9, 8, seed=1)
    src, dst = g0.coo()
    hub, leaves = g0.nv, 3000
    nbrs = np.r_[np.arange(g0.nv), hub + 1 + np.arange(leaves)]
    g = T.sort_and_clean(tcsr.from_edges(
        np.r_[src, np.full(len(nbrs), hub), nbrs],
        np.r_[dst, nbrs, np.full(len(nbrs), hub)], g0.nv + 1 + leaves))
    cg = tcgr.encode_graph(g, tcgr.CgrConfig(use_interval=True,
                                             itv_seg_len=64))
    prep = CD.cgr_device_prep(cg, device="cpu")
    lo = prep["itv_ptr"][hub].item()
    assert prep["nres"][hub].item() == 0
    assert prep["length"][lo:lo + 2].tolist() == [g0.nv, leaves]
    _same(CD.cgr_decode_device(cg, device="cpu"), g, "star")
    assert calls["cgr_merge"] == 1


def test_residual_tables():
    """Tiles cut where the lanes' first ids cross a multiple of
    RESIDUAL_TILE_IDS or their indices one of RESIDUAL_TILE_LANES; the
    order takes each tile's lanes by count, largest first, ties in lane
    order (a negative count as 0); the preps' tables are these."""
    counts = np.array([5, 0, 30, 7, 7, 2, 40, 1, -3, 9, 12, 3])
    c = np.maximum(counts, 0)
    for ids, lanes in ((3072, 256), (20, 256), (1000, 4), (1, 1)):
        with mock.patch.multiple(K12, RESIDUAL_TILE_IDS=ids,
                                 RESIDUAL_TILE_LANES=lanes):
            t = K12.residual_tables(_i32(counts))
        key = (np.cumsum(c) - c) // ids + np.arange(len(c)) // lanes
        ptr = np.r_[0, np.flatnonzero(np.diff(key)) + 1, len(c)]
        np.testing.assert_array_equal(t["tiles"].numpy(), ptr)
        want = np.concatenate([lo + np.argsort(-c[lo:hi], kind="stable")
                               for lo, hi in zip(ptr[:-1], ptr[1:])])
        np.testing.assert_array_equal(t["order"].numpy(), want)
        assert all(x.dtype == torch.int32 for x in t.values())
    with mock.patch.multiple(K12, RESIDUAL_TILE_IDS=20):
        t = K12.residual_tables(_i32(counts))
    # first ids 0 5 5 35 42 49 51 91 92 92 101 113: windows of 20
    assert t["tiles"].tolist() == [0, 3, 4, 7, 10, 12]
    assert t["order"].tolist() == [2, 0, 1, 3, 6, 4, 5, 9, 7, 8, 10, 11]
    _, tt, _ = _streams("rmat9", PLAIN_CONFIGS["default"])
    prep = CD.cgr_device_prep(tt, device="cpu")
    want = K12.residual_tables(prep["counts"])
    for k in ("tiles", "order"):
        assert torch.equal(prep["res_tables"][k], want[k])
    hp = DD.hybrid_device_prep(thybrid.encode_graph(_pair("rmat9")[0],
                                                    threshold=8),
                               device="cpu")
    low = hp["low"]
    want = K12.residual_tables(low[1])
    for k in ("tiles", "order"):
        assert torch.equal(hp["res_tables"][k], want[k])


@pytest.mark.parametrize("threshold", [4, 32])
def test_hybrid_low_rows_through_the_emulated_kernel(emulated, monkeypatch,
                                                     threshold):
    """Hybrid's low rows are not consecutive (high rows lie between them in
    the stream and in col): through the emulated cgr_residual, under the
    prep's tables and under tiles of 3 lanes and 40 ids, they equal the
    plain version, and the decode the graph."""
    calls = _emulated_passes(emulated, monkeypatch)
    g = _pair("rmat9")[0]
    hg = thybrid.encode_graph(g, threshold=threshold)
    got = DD.decode_hybrid_device(hg, device="cpu")
    np.testing.assert_array_equal(got.col_idx, g.col_idx)
    assert calls["cgr_residual"] == 1


def _garbage_lanes():
    """Random bytes under lanes at random bits (negative ones and ones past
    the stream among them), counts of 0 to 60, slots in order."""
    rng = np.random.default_rng(4)
    stream = K12.stream_tensor(rng.integers(0, 256, 2000, dtype=np.uint8)
                               .tobytes(), "cpu")
    n = 700
    counts = rng.integers(0, 61, n)
    counts[::97] = 0
    data_p = rng.integers(-40, 2000 * 8 + 200, n)
    data_p[5:60] = np.sort(data_p[5:60])
    base = np.cumsum(counts) - counts
    lanes = (_i32(data_p), _i32(counts), _i32(rng.integers(0, 5000, n)),
             _i32(base))
    return stream, lanes, int(counts.sum())


@pytest.mark.parametrize("k", [1, 3])
def test_residual_source_emulated_on_a_stream_that_does_not_parse(
        emulated, emulated_small, k):
    """Random bits under random lanes: every read stays inside the stream
    and every id lands in its slot, as the plain version's, under the
    shipped tables, tiny tiles, one tile of every lane, an order that
    names lanes twice and lanes outside their tile, and in the kernel with
    8 staged words and 64 collected ids."""
    stream, lanes, ne = _garbage_lanes()
    want = K12.cgr_residual_plain(stream, *lanes, ne, k)
    t = K12.residual_tables(lanes[1])
    n = lanes[0].numel()
    order = t["order"].clone()
    order[10:20] = order[10]
    order[30:40] = torch.arange(600, 610, dtype=torch.int32)
    tables = [(t["tiles"], t["order"]), (None, None),
              (_i32([0, n]), torch.arange(n, dtype=torch.int32)),
              (t["tiles"], order)]
    with mock.patch.multiple(K12, RESIDUAL_TILE_LANES=3,
                             RESIDUAL_TILE_IDS=40):
        tiny = K12.residual_tables(lanes[1])
    tables.append((tiny["tiles"], tiny["order"]))
    for lib in (emulated, emulated_small):
        for tiles, order in tables:
            got = _emulated_residual(lib, stream, lanes, ne, k, tiles, order)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("name,cfg", [("rmat9", "default"),
                                      ("uniform", "zeta1"),
                                      ("rmat9", "seg64")])
def test_residual_source_emulated_with_small_spans(emulated_small, name,
                                                   cfg):
    """The plain stream's lanes under the prep's tables, in the kernel with
    8 staged words and 64 collected ids a tile: a lane's codes past the
    staged words are read from the stream, its ids past the collected
    slots written directly; still the plain version's."""
    _, t, _ = _streams(name, PLAIN_CONFIGS[cfg])
    prep = CD.cgr_device_prep(t, device="cpu")
    lanes = [prep[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    want = K12.cgr_residual_plain(prep["stream"], *lanes, t.ne,
                                  t.cfg.zeta_k)
    got = _emulated_residual(emulated_small, prep["stream"], lanes, t.ne,
                             t.cfg.zeta_k, **prep["res_tables"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,interval", [
    ("rmat9", "default", False), ("uniform", "zeta1", False),
    ("runs", "itv64", True), ("runs", "add_degree", True)])
def test_kernels_match_plain_on_cuda(name, cfg, interval):
    """Each K12 kernel against its plain version on the prep's lanes on the
    card, exactly, and the whole decode against the graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/cgr_decode.cu "
                    "have no CPU route")
    configs = INTERVAL_CONFIGS if interval else PLAIN_CONFIGS
    g, t, _ = _streams(name, configs[cfg], interval)
    prep = CD.cgr_device_prep(t, device="cuda")
    stream = prep["stream"]

    def same(got, want):
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    seg = _i32(prep["seg_start"]).cuda()
    same(K12.cgr_gamma(stream, seg, K12.COUNT),
         K12.cgr_gamma_plain(stream, seg, K12.COUNT))
    kind = K12.HEADER_DEG if t.cfg.add_degree else K12.HEADER
    same(K12.cgr_gamma(stream, prep["bit_off"], kind),
         K12.cgr_gamma_plain(stream, prep["bit_off"], kind))
    lanes = [prep[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    col, pfin = K12.cgr_residual(stream, *lanes, t.ne, t.cfg.zeta_k)
    pcol, ppfin = K12.cgr_residual_plain(stream, *lanes, t.ne, t.cfg.zeta_k)
    assert torch.equal(pfin, ppfin)
    tcol, tpfin = K12.cgr_residual(stream, *lanes, t.ne, t.cfg.zeta_k,
                                   **prep["res_tables"])
    assert torch.equal(tpfin, ppfin)
    if interval:
        # the residual lanes leave the interval ids' slots as allocated
        margs = (prep["row_ptr_d"], prep["nres"], prep["itv_ptr"],
                 prep["left"], prep["length"], prep["itv_pre"])
        assert torch.equal(K12.cgr_merge(tcol, *margs),
                           K12.cgr_merge_plain(pcol, *margs))
    else:
        assert torch.equal(tcol, pcol)
    if interval:
        ilanes = prep["itv_lanes"]
        n_itv = prep["left"].numel()
        same(K12.cgr_interval(stream, *ilanes, n_itv, t.cfg.min_itv_len),
             K12.cgr_interval_plain(stream, *ilanes, n_itv,
                                    t.cfg.min_itv_len))
        margs = (col, prep["row_ptr_d"], prep["nres"], prep["itv_ptr"],
                 prep["left"], prep["length"], prep["itv_pre"])
        assert torch.equal(K12.cgr_merge(*margs), K12.cgr_merge_plain(*margs))
    else:
        assert torch.equal(col, pcol)
    _same(CD.cgr_decode_device(t, device="cuda"), g, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["header", "header_deg", "count", "res_pos",
                                  "count_shuffled", "count_unaligned"])
def test_gamma_cases_on_cuda(case):
    """cgr_gamma on the card against its plain version on each kind of
    launch, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/cgr_decode.cu "
                    "have no CPU route")
    stream, pos, kind = _gamma_case(case)
    want = K12.cgr_gamma_plain(stream, pos, kind)
    got = K12.cgr_gamma(stream.cuda(), pos.cuda(), kind)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "hybrid", "garbage"])
def test_residual_routes_on_cuda(case):
    """cgr_residual on the card against the plain version: the plain
    stream's lanes, hybrid's low rows (not consecutive), random lanes on
    random bits; under the prep's tables, the tables the wrapper builds,
    tiles of 3 lanes and 40 ids, one tile of every lane, and an order that
    names lanes twice and lanes outside their tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/cgr_decode.cu "
                    "have no CPU route")
    if case == "garbage":
        stream, lanes, ne = _garbage_lanes()
        k, tables = 3, None
    elif case == "plain":
        _, t, _ = _streams("rmat9", PLAIN_CONFIGS["default"])
        prep = CD.cgr_device_prep(t, device="cpu")
        stream, ne, k = prep["stream"], t.ne, t.cfg.zeta_k
        lanes = [prep[x] for x in ("data_p", "counts", "lane_v_d", "base")]
        tables = prep["res_tables"]
    else:
        hp = DD.hybrid_device_prep(thybrid.encode_graph(
            _pair("rmat9")[0], threshold=8), device="cpu")
        stream, lanes, ne, k = hp["stream"], hp["low"], hp["ne"], hp["zeta_k"]
        tables = hp["res_tables"]
    stream, lanes = stream.cuda(), [a.cuda() for a in lanes]
    want = K12.cgr_residual_plain(stream, *lanes, ne, k)
    n = lanes[0].numel()
    t = K12.residual_tables(lanes[1])
    order = t["order"].clone()
    order[10:20] = order[10]
    order[30:40] = torch.arange(n - 10, n, dtype=torch.int32, device="cuda")
    with mock.patch.multiple(K12, RESIDUAL_TILE_LANES=3,
                             RESIDUAL_TILE_IDS=40):
        tiny = K12.residual_tables(lanes[1])
    cases = [{}, tiny, dict(t, order=order),
             {"tiles": torch.tensor([0, n], dtype=torch.int32, device="cuda"),
              "order": torch.arange(n, dtype=torch.int32, device="cuda")}]
    if tables is not None:
        cases.append({x: v.cuda() for x, v in tables.items()})
    for tb in cases:
        col, pfin = K12.cgr_residual(stream, *lanes, ne, k, **tb)
        torch.cuda.synchronize()
        if case == "hybrid":   # the high rows' slots are not cgr_residual's
            keep = torch.zeros(ne, dtype=torch.bool, device="cuda")
            keep[(lanes[3].long().repeat_interleave(lanes[1].long())
                  + torch.arange(int(lanes[1].sum()), device="cuda")
                  - (torch.cumsum(lanes[1].long(), 0)
                     - lanes[1].long()).repeat_interleave(
                         lanes[1].long()))] = True
            assert torch.equal(col[keep], want[0][keep])
        else:
            assert torch.equal(col, want[0])
        assert torch.equal(pfin, want[1])


class _CardOnHost:
    """A device the wrappers take for a card (its ``type`` is cuda and it
    equals every tensor's device): their kernel route, on host tensors."""

    type = "cuda"

    def __eq__(self, other):
        return True

    def __ne__(self, other):
        return False


class _HostTorch:
    """torch, with ``empty`` allocating on the host whatever device it is
    given."""

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, device=None, **kw):
        return torch.empty(*args, **kw)


def test_the_wrappers_kernel_route_through_the_emulated_kernels(
        emulated, tmp_path, monkeypatch):
    """The decodes through the wrappers' kernel route (their table checks,
    the tables they build without the prep's, their launches), each kernel
    the emulated source of csrc/: VarintGB (with vgb_values' tables and
    without), plain and interval CGR, hybrid, the streamed count and BFS
    equal the graph, each wrapper counting its launches."""
    from graphaibench_tpu_torch.analytics import bfs
    from graphaibench_tpu_torch.analytics import tc_stream as TS
    from graphaibench_tpu_torch.compress import vbyte as tvbyte
    from graphaibench_tpu_torch.ops import vbyte_decode as K11
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph
    from test_torch_device_decode import EMULATION as VBYTE_EMULATION

    vbyte = build_emulated(tmp_path, "vbyte_decode.cu", 3, VBYTE_EMULATION)
    libs = {"cgr_decode": emulated, "vbyte_decode": vbyte}
    monkeypatch.setattr(_build, "load_library", libs.__getitem__)
    for mod in (K11, K12):
        check = mod._check

        def on_card(*args, check=check):
            check(*args)
            return _CardOnHost()

        monkeypatch.setattr(mod, "_check", on_card)
        monkeypatch.setattr(mod, "_launch_tail", lambda t: (0, None))
        monkeypatch.setattr(mod, "torch", _HostTorch())
    g = _pair("rmat9")[0]
    before = {**K11.LAUNCHES, **K12.LAUNCHES}
    vg = tvbyte.encode_graph(g, "varintgb")
    prep = DD.varintgb_device_prep(vg, device="cpu")
    np.testing.assert_array_equal(DD.varintgb_device_run(prep).numpy(),
                                  g.col_idx)
    tags = K11.vgb_tags(prep["stream"], prep["pos"], prep["ngroups"],
                        prep["gbase"], prep["n_g"])
    col = K11.vgb_values(prep["stream"], tags, prep["gbase"], prep["counts"],
                         prep["out_slot"], torch.empty(g.ne,
                                                       dtype=torch.int32))
    np.testing.assert_array_equal(col.numpy(), g.col_idx)
    for interval in (False, True):
        cg = tcgr.encode_graph(g, _cfg({}, interval)[0])
        _same(CD.cgr_decode_device(cg, device="cpu"), g, str(interval))
    hg = thybrid.encode_graph(g, threshold=8)
    np.testing.assert_array_equal(
        DD.hybrid_device_run(DD.hybrid_device_prep(hg, device="cpu")).numpy(),
        g.col_idx)
    cg = tcgr.encode_graph(g)
    n, stats = TS.triangle_count_streaming(cg, block_bytes=1 << 14,
                                           device="cpu")
    assert n == TS.triangle_count_streaming(cg, block_bytes=1 << 30,
                                            device="cpu")[0]
    assert stats["blocks"] >= 2
    got = TS.bfs_streaming(cg, 0, block_bytes=1 << 14, device="cpu")
    assert np.array_equal(got, bfs(to_device_graph(g, device="cpu"),
                                   0).numpy())
    after = {**K11.LAUNCHES, **K12.LAUNCHES}
    assert after["vgb_values"] - before["vgb_values"] == 2
    launched = after["cgr_residual"] - before["cgr_residual"]
    assert launched >= 4 + stats["blocks"]
