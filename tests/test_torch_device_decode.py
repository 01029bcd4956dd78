"""The port's decode of the byte codecs on the device
(``graphaibench_tpu_torch/compress/device_decode.py``, the kernels K11 of
``csrc/vbyte_decode.cu`` with their wrappers and plain versions in
``ops/vbyte_decode.py``), held against the JAX package's
``compress/device_decode.py`` and the host decoders on the CPU.

All of it is int32 and must be exact. On the CPU each wrapper takes its
plain version: each plain pass is held against the JAX program it replaces
on the same inputs (``streamvbyte_decode_device``, ``_vgb_tag_chain``'s tag
positions, ``_vgb_flat_values``), and each whole decode against JAX's
device decoder (jit on the JAX CPU backend), the host decoder and the
graph, on rmat9-10 and on the handmade graphs of ``tests/test_compress.py``
(:158-227): zero-degree rows, ids of 1 to 4 bytes, 4-byte lanes from ids of
2^24 and up, partial final groups, tags at every in-word alignment, a hub.
``vgb_tags`` and ``svb_decode`` are also compiled here with g++ against a
header that emulates the CUDA they use (a block's threads as host threads
that meet at ``__syncthreads``, a warp's at ``__syncwarp`` and around each
shuffle, shared memory static, an asynchronous copy done at once) and run their blocks one after another,
each held against its plain version under its tables at the shipped sizes
and at small ones. Hybrid's encoder refuses a row it would send to CGR
that is not strictly increasing, where JAX's writes a stream it decodes
wrongly: a stated difference, held here. The kernels themselves
run on the card in the tests marked ``cuda`` and in ``chip_smoke.py``'s
``compress`` phase.
"""

import ctypes
import re
import shutil
import subprocess
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.compress import device_decode as JDD
from graphaibench_tpu.compress import hybrid as jhybrid
from graphaibench_tpu.compress import vbyte as jvbyte
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu_torch.analytics import run_benchmark
from graphaibench_tpu_torch.compress import cli as tccli
from graphaibench_tpu_torch.compress import device_decode as DD
from graphaibench_tpu_torch.compress import hybrid as thybrid
from graphaibench_tpu_torch.compress import vbyte as tvbyte
from graphaibench_tpu_torch.compress.cgr_device import StreamRefused
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import vbyte_decode as K11

torch.set_num_threads(2)


def _sym(n, src, dst):
    src, dst = np.asarray(src), np.asarray(dst)
    return tcsr.from_edges(np.r_[src, dst], np.r_[dst, src], n)


def _svb_cases():
    """tests/test_compress.py:169-183: zero-degree rows, 1-vertex rows, ids
    needing 1 to 3 bytes."""
    return _sym(70000, [0, 0, 0, 5, 5, 69999, 3], [1, 300, 69999, 6, 70, 0, 3])


def _vgb_cases():
    """tests/test_compress.py:201-217: multi-byte lanes at every in-word tag
    alignment, zero-degree rows, partial final groups, a row of 40."""
    hub = 17
    return _sym(70000, [0, 0, 0, 5, 5, 69999] + [hub] * 40,
                [1, 300, 69999, 6, 70, 0] + list(range(40000, 40040)))


def _wide():
    """tests/test_compress.py:220-234: ids of 2^24 and up (4-byte lanes),
    for both the absolute ids and the wide gaps."""
    n = (1 << 24) + 64
    big = n - 2
    return _sym(n, [0, 0, 0, 3, 3, big], [1, 2, big, 5, big - 1, big - 3])


GRAPHS = {
    "rmat9": lambda: T.sort_and_clean(tgen.rmat(9, 8, seed=1)),
    "rmat10": lambda: T.sort_and_clean(tgen.rmat(10, 8, seed=2)),
    "svb_cases": _svb_cases,
    "vgb_cases": _vgb_cases,
    "wide": _wide,
}
_CACHE = {}


def _fast_vbyte(g, scheme):
    """The port's ``vbyte.encode_graph`` bytes, with the empty rows' count
    words laid out by numpy (the wide graph has 2^24 rows)."""
    enc = tvbyte._CODECS[scheme][0]
    deg = g.degrees()
    words = np.ones(g.nv, np.int64)
    chunks = {}
    for v in np.nonzero(deg)[0]:
        chunks[v] = enc(g.neighbors(v))
        words[v] = len(chunks[v]) // 4
    offsets = np.r_[0, np.cumsum(words)]
    data = np.zeros(offsets[-1] * 4, np.uint8)
    for v, b in chunks.items():
        data[offsets[v] * 4:offsets[v] * 4 + len(b)] = np.frombuffer(b,
                                                                     np.uint8)
    return tvbyte.VbyteGraph(nv=g.nv, ne=g.ne, scheme=scheme, offsets=offsets,
                             data=data.tobytes(), degrees=deg)


def _graph(name):
    if name not in _CACHE:
        _CACHE[name] = GRAPHS[name]()
    return _CACHE[name]


def _encoded(name, scheme):
    key = (name, scheme)
    if key not in _CACHE:
        g = _graph(name)
        _CACHE[key] = (_fast_vbyte(g, scheme) if name == "wide"
                       else tvbyte.encode_graph(g, scheme))
    return _CACHE[key]


def _jax_vbyte(vg):
    return jvbyte.VbyteGraph(nv=vg.nv, ne=vg.ne, scheme=vg.scheme,
                             offsets=vg.offsets, data=vg.data,
                             degrees=vg.degrees)


def _jax_hybrid(hg):
    return jhybrid.HybridGraph(
        nv=hg.nv, ne=hg.ne, threshold=hg.threshold, zeta_k=hg.zeta_k,
        vbyte_scheme=hg.vbyte_scheme, offsets=hg.offsets, data=hg.data,
        degrees=hg.degrees)


def _jax_graph(g):
    return jcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx)


def _same(got, g):
    np.testing.assert_array_equal(got.row_ptr, g.row_ptr)
    np.testing.assert_array_equal(got.col_idx, g.col_idx)
    assert got.col_idx.dtype == np.int32


def test_the_fast_encoder_writes_the_encoders_bytes():
    g = _graph("svb_cases")
    for scheme in ("streamvbyte", "varintgb"):
        a, b = _fast_vbyte(g, scheme), tvbyte.encode_graph(g, scheme)
        assert a.data == b.data
        np.testing.assert_array_equal(a.offsets, b.offsets)


# ---- the whole decodes -----------------------------------------------------

@pytest.mark.parametrize("name", ["rmat9", "rmat10", "svb_cases", "wide"])
def test_streamvbyte_equals_jax_and_the_host(name):
    g, vg = _graph(name), _encoded(name, "streamvbyte")
    got = DD.decode_graph_device(vg, device="cpu")
    _same(got, g)
    want = JDD.decode_graph_device(_jax_vbyte(vg))
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    if name != "wide":
        _same(tvbyte.decode_graph(vg), g)


@pytest.mark.parametrize("name", ["rmat9", "rmat10", "vgb_cases", "wide"])
def test_varintgb_equals_jax_and_the_host(name):
    g, vg = _graph(name), _encoded(name, "varintgb")
    got = DD.decode_graph_device(vg, device="cpu")
    _same(got, g)
    _same(DD.varintgb_decode_device(vg, device="cpu"), g)
    want = JDD.varintgb_decode_device(_jax_vbyte(vg))
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    if name != "wide":
        _same(tvbyte.decode_graph(vg), g)


@pytest.mark.parametrize("name,threshold", [
    ("rmat9", 32), ("rmat10", 8), ("rmat10", 64), ("vgb_cases", 2),
    ("svb_cases", 2)])
def test_hybrid_equals_jax_and_the_host(name, threshold):
    g = _graph(name)
    hg = thybrid.encode_graph(g, threshold=threshold)
    got = DD.decode_hybrid_device(hg, device="cpu")
    _same(got, g)
    want = JDD.decode_hybrid_device(_jax_hybrid(hg))
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    _same(thybrid.decode_graph(hg), g)


# rows 0 and 69999 of both handmade graphs repeat an id: [1, 300, 69999,
# 69999] and [0, 0] (and svb_cases' row 3 is [3, 3])
@pytest.mark.parametrize("threshold", [3, 4, 8])
@pytest.mark.parametrize("name", ["svb_cases", "vgb_cases"])
def test_hybrid_refuses_repeated_ids_in_a_cgr_row(name, threshold):
    """A row below the threshold goes to CGR, which needs a strictly
    increasing row: the port's encoder raises CGR's ValueError. At
    threshold 2 every such row is a StreamVByte chunk, which may repeat ids,
    and the stream is byte-equal to JAX's."""
    g = _graph(name)
    with pytest.raises(ValueError, match="strictly increasing"):
        thybrid.encode_graph(g, threshold=threshold)
    hg = thybrid.encode_graph(g, threshold=2)
    jh = jhybrid.encode_graph(_jax_graph(g), threshold=2)
    assert hg.data == jh.data
    np.testing.assert_array_equal(hg.offsets, jh.offsets)


# what the JAX package does with the same graphs: row 0's decode at
# threshold 8 on the device
_JAX_ROW0 = {"svb_cases": [1, 300, 69999, 95088],
             "vgb_cases": [1, 300, 69999, 95089]}


@pytest.mark.parametrize("name", ["svb_cases", "vgb_cases"])
def test_jax_hybrid_writes_a_stream_it_decodes_wrongly(name):
    """The stated difference: JAX's encoder writes the stream at thresholds
    3, 4 and 8, its host decode raises IndexError on it, and its device
    decode at threshold 8 gives row 0 an id past nv."""
    g = _graph(name)
    for threshold in (3, 4, 8):
        jh = jhybrid.encode_graph(_jax_graph(g), threshold=threshold)
        with pytest.raises(IndexError):
            jhybrid.decode_graph(jh)
    got = JDD.decode_hybrid_device(jh)
    row0 = np.asarray(got.col_idx)[got.row_ptr[0]:got.row_ptr[1]]
    assert row0.tolist() == _JAX_ROW0[name]
    assert row0.max() >= g.nv


def test_the_cli_refuses_a_hybrid_with_repeated_ids(tmp_path):
    """``compress compress -s hybrid`` raises before it writes a file."""
    d = str(tmp_path / "g")
    tio.save_graph(_graph("vgb_cases"), d)
    prefix = tmp_path / "out" / "h"
    with pytest.raises(ValueError, match="strictly increasing"):
        tccli.main(["compress", d, str(prefix), "-s", "hybrid", "-t", "8"])
    assert not prefix.parent.exists() or not any(prefix.parent.iterdir())
    assert tccli.main(["compress", d, str(prefix), "-s", "hybrid", "-t",
                       "2"]) == 0


def test_hybrid_decode_takes_the_two_kernels_once(monkeypatch):
    """The low-degree rows are one cgr_residual call, a lane a row from the
    bit after its gamma degree; the high-degree rows one svb_decode call
    into the same col."""
    calls = []
    for mod, name in ((K12, "cgr_residual"), (K11, "svb_decode")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    g = _graph("rmat10")
    hg = thybrid.encode_graph(g)
    prep = DD.hybrid_device_prep(hg, device="cpu")
    deg = g.degrees()
    low = np.nonzero((deg > 0) & (deg < hg.threshold))[0]
    assert prep["low"][2].tolist() == low.tolist()
    assert prep["high"][0].numel() == int((deg >= hg.threshold).sum()) > 0
    col = DD.hybrid_device_run(prep)
    assert calls == ["cgr_residual", "svb_decode"]
    np.testing.assert_array_equal(col.numpy(), g.col_idx)


# ---- the plain passes against the JAX programs ----------------------------

def _jax_words(data: bytes, pad: int):
    return jnp.asarray(np.frombuffer(data + b"\x00" * pad, dtype=np.uint32))


@pytest.mark.parametrize("name", ["rmat10", "svb_cases"])
def test_svb_plain_equals_jax_streamvbyte_decode_device(name):
    """Whole-graph rows (a count word before the keys) and the hybrid's
    count-word-free chunks at byte offsets."""
    vg = _encoded(name, "streamvbyte")
    stream = K12.stream_tensor(vg.data, "cpu")
    woff = torch.from_numpy(vg.offsets.astype(np.int32))
    deg = torch.from_numpy(vg.degrees.astype(np.int32))
    rp, col = DD.streamvbyte_decode_device(stream, woff, deg, nv=vg.nv,
                                           ne=vg.ne)
    jrp, jcol = JDD.streamvbyte_decode_device(
        _jax_words(vg.data, (-len(vg.data)) % 4 + 8),
        jnp.asarray(woff.numpy()), jnp.asarray(deg.numpy()), nv=vg.nv,
        ne=vg.ne)
    np.testing.assert_array_equal(rp.numpy(), np.asarray(jrp))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    # svb_cases repeats ids in rows of degree 2 ([3, 3], [0, 0]), which the
    # encoder refuses to send to CGR: at threshold 2 every row is a chunk
    threshold = 2 if name == "svb_cases" else 3
    hg = thybrid.encode_graph(_graph(name), threshold=threshold)
    high = np.nonzero(hg.degrees >= threshold)[0]
    stream = K12.stream_tensor(hg.data, "cpu")
    off = hg.offsets[high].astype(np.int32)
    hdeg = hg.degrees[high].astype(np.int32)
    _, col = DD.streamvbyte_decode_device(
        stream, torch.from_numpy(np.r_[off, 0].astype(np.int32)),
        torch.from_numpy(hdeg), nv=len(high), ne=int(hdeg.sum()),
        count_word=False)
    _, jcol = JDD.streamvbyte_decode_device(
        _jax_words(hg.data, (-len(hg.data)) % 4 + 16), jnp.asarray(off),
        jnp.asarray(hdeg), nv=len(high), ne=int(hdeg.sum()), count_word=False)
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))


def _jax_tagpos(vg):
    """JAX's tag positions of a VarintGB graph: its prep's buckets through
    ``_vgb_tag_chain``, the (n_g,) positions."""
    prep = JDD.varintgb_device_prep(_jax_vbyte(vg))
    tagpos = jnp.zeros((max(prep["n_g"], 1) + 1,), jnp.int32)
    for bk in prep["buckets"]:
        tagpos = JDD._vgb_tag_chain(prep["blocks"], prep["lut"], bk["pos"],
                                    bk["ngl"], bk["gbase"], tagpos, bk["trip"])
    return prep, np.asarray(tagpos)[:prep["n_g"]]


@pytest.mark.parametrize("name", ["rmat9", "rmat10", "vgb_cases"])
def test_vgb_plain_passes_equal_jax_tag_chain_and_flat_values(name):
    vg = _encoded(name, "varintgb")
    jprep, jtags = _jax_tagpos(vg)
    prep = DD.varintgb_device_prep(vg, device="cpu")
    assert prep["n_g"] == jprep["n_g"]
    tags = K11.vgb_tags(prep["stream"], prep["pos"], prep["ngroups"],
                        prep["gbase"], prep["n_g"])
    np.testing.assert_array_equal(tags.numpy(), jtags)
    col = K11.vgb_values(prep["stream"], tags, prep["gbase"], prep["counts"],
                         prep["out_slot"], torch.zeros(vg.ne,
                                                       dtype=torch.int32))
    jcol = JDD._vgb_flat_values(
        jprep["words"], jnp.asarray(np.r_[jtags, 0].astype(np.int32)),
        jprep["group_ptr_d"], jprep["row_ptr_d"], jprep["deg_d"], nv=vg.nv,
        ne=vg.ne, n_g=jprep["n_g"])
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))


def test_vgb_glen_is_jaxs():
    np.testing.assert_array_equal(K11.VGB_GLEN, JDD._VGB_GLEN)


# ---- hubs past JAX's trip grids --------------------------------------------

def test_a_varintgb_hub_past_jaxs_trip_grid_decodes():
    """JAX refuses a row past 4 * _VGB_SUBS * 4096 values; the port's
    kernels loop over the row's own count (tests/test_compress.py:237-270)."""
    limit = 4 * JDD._VGB_SUBS * JDD._VGB_TRIP_GRID[-1]
    hub = limit + 4
    g = _sym(limit + 8, np.zeros(hub, np.int64), np.arange(1, hub + 1))
    vg = _fast_vbyte(g, "varintgb")
    with pytest.raises(ValueError, match="trip grid"):
        JDD.varintgb_decode_device(_jax_vbyte(vg))
    _same(DD.varintgb_decode_device(vg, device="cpu"), g)


def test_a_hybrid_hub_under_a_large_threshold_decodes():
    """A hub of degree 2,500 under threshold 3,000 goes down the low-degree
    lanes, past JAX's hybrid grid (tests/test_compress.py:273-296)."""
    hub = 2500
    g = _sym(hub + 1, np.zeros(hub, np.int64), np.arange(1, hub + 1))
    hg = thybrid.encode_graph(g, threshold=3000)
    with pytest.raises(ValueError, match="hybrid trip grid"):
        JDD.decode_hybrid_device(_jax_hybrid(hg))
    _same(DD.decode_hybrid_device(hg, device="cpu"), g)


# ---- refusals and faults ---------------------------------------------------

class _Len(bytes):
    """Bytes that report another length (a stream too large to build)."""

    def __new__(cls, n):
        obj = super().__new__(cls, b"\x00" * 8)
        obj.n = n
        return obj

    def __len__(self):
        return self.n


def _refused(fn, obj, match):
    with pytest.raises(StreamRefused, match=match):
        fn(obj, device="cpu")


@pytest.mark.parametrize("scheme", ["streamvbyte", "varintgb", "hybrid"])
def test_streams_the_device_route_refuses(scheme):
    g = _graph("rmat9")
    if scheme == "hybrid":
        obj, fn = thybrid.encode_graph(g), DD.decode_hybrid_device
        n_off = len(obj.data)
    else:
        obj, fn = tvbyte.encode_graph(g, scheme), DD.decode_graph_device
        n_off = len(obj.data) // 4
    deg = obj.degrees.copy()
    deg[3] += 1
    _refused(fn, _replace(obj, degrees=deg), "summing")
    deg = obj.degrees.copy()
    deg[3], deg[4] = -1, deg[4] + deg[3] + 1
    _refused(fn, _replace(obj, degrees=deg), "non-negative")
    off = obj.offsets.copy()
    v = int(np.nonzero(g.degrees())[0][-1])
    off[v] = n_off + 64
    _refused(fn, _replace(obj, offsets=off), "past the padded")
    _refused(fn, _replace(obj, data=_Len(2**31 if scheme != "hybrid"
                                         else 2**28)), "int32")


def _replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def test_a_varintgb_hybrid_is_refused_and_decoded_on_the_host(tmp_path,
                                                              capsys):
    g = _graph("rmat10")
    hg = thybrid.encode_graph(g, vbyte_scheme="varintgb")
    _refused(DD.decode_hybrid_device, hg, "varintgb chunks")
    prefix = str(tmp_path / "hyb" / "g")
    tccli.save_compressed(hg, prefix)
    assert run_benchmark("tc", prefix, [], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("decoded on host (device hybrid decode: "
                               "varintgb chunks") for line in out)
    assert "Correct" in out


def test_wrappers_refuse_bad_operands():
    stream = K12.stream_tensor(b"\xff" * 8, "cpu")
    rows = torch.zeros(3, dtype=torch.int32)
    col = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32") as e:
        K11.svb_decode(stream, rows.long(), rows, rows, col)
    assert not isinstance(e.value, StreamRefused)
    with pytest.raises(ValueError, match="uint8"):
        K11.svb_decode(stream.to(torch.int16), rows, rows, rows, col)
    with pytest.raises(ValueError, match="different lengths"):
        K11.vgb_tags(stream, rows, rows, rows[:2], 4)
    with pytest.raises(ValueError, match="int32"):
        K11.vgb_values(stream, col.float(), rows, rows, rows, col)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K11.vgb_tags(stream.to("meta"), *(rows.to("meta"),) * 3, 4)
    with pytest.raises(ValueError, match="expected streamvbyte"):
        DD.streamvbyte_device_prep(_encoded("rmat9", "varintgb"),
                                   device="cpu")


def test_a_stream_that_does_not_parse_reads_inside_it():
    """Random bytes under valid tables: every read is clamped to the stream,
    every write lands in its slot, the result is what the arithmetic gives
    (the kernels, on the card, must give the same)."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    stream = K12.stream_tensor(data, "cpu")
    counts = torch.tensor([7, 0, 40, 3], dtype=torch.int32)
    start = torch.tensor([60, 5, 50, 70], dtype=torch.int32)
    slot = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    col = K11.svb_decode(stream, start, counts, slot,
                         torch.full((50,), -7, dtype=torch.int32))
    assert (col != -7).all()
    ng = (counts + 3) // 4
    gb = torch.cumsum(ng, 0, dtype=torch.int32) - ng
    tags = K11.vgb_tags(stream, start, ng, gb, int(ng.sum()))
    assert tags.numel() == 13
    col = K11.vgb_values(stream, tags, gb, counts, slot,
                         torch.full((50,), -7, dtype=torch.int32))
    assert (col != -7).all()


# ---- vgb_tags' source, emulated on the host --------------------------------

EMULATION = r"""
#pragma once
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 { unsigned x = 0; };
static thread_local dim3 blockIdx, threadIdx;
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <class T> inline T __ldg(const T* p) { return *p; }
// a block's threads are host threads, __syncthreads a barrier among them
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n, waiting = 0, gen = 0;
  explicit Barrier(unsigned n) : n(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const unsigned g = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
static Barrier* block_barrier;
inline void __syncthreads() { block_barrier->wait(); }
// a warp's 32 threads meet at a barrier of their own: __syncwarp, and a
// shuffle through an exchange between two such meetings (every lane of the
// warp shuffles together, as the kernels' full masks require)
static Barrier* warp_barrier[32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  warp_barrier[threadIdx.x >> 5]->wait();
}
static unsigned long long shuffled[1024];
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
  const unsigned t = threadIdx.x;
  shuffled[t] = static_cast<unsigned long long>(v);
  __syncwarp();
  const T r = (t & 31) >= static_cast<unsigned>(d)
                  ? static_cast<T>(shuffled[t - d]) : v;
  __syncwarp();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  const unsigned t = threadIdx.x;
  shuffled[t] = static_cast<unsigned long long>(v);
  __syncwarp();
  const T r = static_cast<T>(shuffled[(t & ~31u) + src]);
  __syncwarp();
  return r;
}
static std::mutex atomics;
inline long long atomicMin(long long* p, long long v) {
  std::lock_guard<std::mutex> g(atomics);
  const long long o = *p;
  if (v < o) *p = v;
  return o;
}
inline long long atomicMax(long long* p, long long v) {
  std::lock_guard<std::mutex> g(atomics);
  const long long o = *p;
  if (v > o) *p = v;
  return o;
}
// the grid's blocks one after another, each by `block` host threads
inline void emulate(unsigned grid, unsigned block, std::function<void()> f) {
  Barrier bar(block);
  block_barrier = &bar;
  std::vector<Barrier*> warps;
  for (unsigned w = 0; w < block / 32; ++w) {
    warps.push_back(new Barrier(32));
    warp_barrier[w] = warps.back();
  }
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        f();
        bar.wait();
      }
    });
  for (auto& th : threads) th.join();
  for (Barrier* w : warps) delete w;
}
"""


# cuda_pipeline.h for the emulation: an asynchronous copy to shared memory
# completes at once
PIPELINE = r"""
#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""


def build_emulated(d, source: str, launches: int, header: str,
                   consts=None) -> ctypes.CDLL:
    """The library of ``csrc/<source>`` built by g++ for the host in ``d``
    against ``header`` (as ``cuda_runtime.h``) and PIPELINE, each launch
    ``k<<<grid, block, 0, s>>>(args)`` (``launches`` of them) run by
    ``emulate``; ``consts`` gives some of its ``constexpr int`` constants
    other values (each must be found once)."""
    (d / "cuda_runtime.h").write_text(header)
    (d / "cuda_pipeline.h").write_text(PIPELINE)
    src = (_build.CSRC / source).read_text()
    for name, value in (consts or {}).items():
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    src, n = re.subn(r"(\w+)<<<(.*?),\s*(\w+),\s*0,\s*(.*?)>>>\((.*?)\);",
                     r"emulate(\2, \3, [&] { \1(\5); });", src,
                     flags=re.S)
    assert n == launches
    (d / "k.cpp").write_text(src)
    subprocess.run(["g++", "-O1", "-std=c++17", "-pthread", "-shared",
                    "-fPIC", f"-I{d}", str(d / "k.cpp"), "-o",
                    str(d / "k.so")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "k.so"))
    for fn, argtypes in _build._SIGNATURES[source[:-3]].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The library of ``csrc/vbyte_decode.cu`` built by g++ for the host,
    each launch ``k<<<grid, block, 0, s>>>(args)`` run block after block,
    a block's threads as host threads that meet at ``__syncthreads``; only
    ``gab_vgb_tags``, ``gab_svb_decode`` and ``gab_vgb_values`` are
    called."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("vbyte_emulated"),
                          "vbyte_decode.cu", 3, EMULATION)


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The same library with vgb_values' block spans cut down: a group a
    thread (256 a tile, 1,024 collected ids, a long row 255 groups a round)
    and 48 staged bytes, so that the shipped tables' rows leave the tile's
    groups and its groups the staged bytes."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("vbyte_small"),
                          "vbyte_decode.cu", 3, EMULATION,
                          {"kValPerThread": 1, "kValWin": 48})


def _emulated_tags(lib, stream, pos, ngroups, gbase, n_g, tables):
    tagpos = torch.full((n_g,), -1, dtype=torch.int32)
    lr, tiles = tables["long_rows"], tables["tiles"]
    assert lib.gab_vgb_tags(stream.data_ptr(), stream.numel(), pos.data_ptr(),
                            ngroups.data_ptr(), gbase.data_ptr(), pos.numel(),
                            lr.data_ptr(), lr.numel(), tiles.data_ptr(),
                            tiles.shape[0] - 1, K11.VGB_LONG_GROUPS,
                            tagpos.data_ptr(), n_g, 0, None) == 0
    return tagpos


def _vgb_rows(adjs):
    """Rows encoded as ``vbyte.encode_graph`` lays them out (count word,
    groups, padding to a word): (stream, pos, ngroups, gbase, n_g, the
    rows' byte boundaries)."""
    chunks = [tvbyte.varintgb_encode(np.asarray(a, np.int64)) for a in adjs]
    bounds = np.cumsum([0] + [len(c) for c in chunks])
    deg = np.array([len(a) for a in adjs])
    ng = (deg + 3) // 4
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return (K12.stream_tensor(b"".join(chunks), "cpu"),
            i32(np.where(deg > 0, bounds[:-1] + 4, 0)), i32(ng),
            i32(np.cumsum(ng) - ng), int(ng.sum()), bounds)


def _hub_rows():
    """A hub of 12,000 ids, gaps of one to four bytes (so tags at every
    alignment, 23 KB of groups: wider than the kernel's 15,872-byte window
    and its 16,384-byte rounds), among short rows, an empty row and a
    second long row."""
    rng = np.random.default_rng(5)
    nbytes = rng.choice([1, 2, 3], 12000, p=[0.5, 0.3, 0.2])
    gaps = rng.integers(1, 256, 12000) << (8 * (nbytes - 1))
    hub = np.cumsum(gaps)
    hub[100::997] += np.int64(1) << 24           # 4-byte gaps now and then
    hub = np.maximum.accumulate(hub)
    return [np.arange(3) * 7, hub, [], np.arange(50) * 300,
            np.cumsum(rng.integers(1, 70000, 1100)), [9], np.arange(17)]


def _garbage_rows(long: bool):
    rng = np.random.default_rng(1)
    if not long:
        ngroups = torch.tensor([3, 0, 9, 40], dtype=torch.int32)
        pos = torch.tensor([0, 7, 90, 200], dtype=torch.int32)
        data = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    else:
        # chains of up to 5,000 groups over 40,000 random bytes: past the
        # stream's end (clamped reads), over several rounds, from a
        # negative position and one past the end
        ngroups = torch.tensor([300, 5000, 0, 40, 1000, 700, 257],
                               dtype=torch.int32)
        pos = torch.tensor([13, 17, 0, 39990, -5, 41000, 20011],
                           dtype=torch.int32)
        data = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    gbase = torch.cumsum(ngroups, 0, dtype=torch.int32) - ngroups
    return (K12.stream_tensor(data, "cpu"), pos, ngroups, gbase,
            int(ngroups.sum()), None)


def _tag_case(name):
    if name == "garbage":
        return _garbage_rows(long=False)
    if name == "garbage_long":
        return _garbage_rows(long=True)
    if name == "hub":
        return _vgb_rows(_hub_rows())
    vg = _encoded(name, "varintgb")
    prep = DD.varintgb_device_prep(vg, device="cpu")
    return (prep["stream"], prep["pos"], prep["ngroups"], prep["gbase"],
            prep["n_g"], np.asarray(vg.offsets[:vg.nv + 1]) * 4)


@pytest.mark.parametrize("name", ["rmat9", "vgb_cases", "garbage", "hub",
                                  "garbage_long"])
def test_vgb_tags_source_emulated_equals_plain(emulated, name, monkeypatch):
    """The kernel against the plain version under the tables the prep
    builds (tiles cut at the rows' bytes) and those built without byte
    offsets (tiles of VGB_TILE_ROWS rows), each at the shipped sizes and,
    but for the 70,000 rows of vgb_cases (a block's 256 host threads meet
    at every barrier), at small ones: a long row from 9 groups on, tiles of
    64 bytes or 5 rows, so that many rows are long and a tile's window
    misses rows; and under tables whose windows are shifted off the rows
    or empty."""
    stream, pos, ngroups, gbase, n_g, bounds = _tag_case(name)
    want = K11.vgb_tags_plain(stream, pos, ngroups, gbase, n_g)
    small = {"VGB_LONG_GROUPS": 8, "VGB_TILE_BYTES": 64, "VGB_TILE_ROWS": 5}
    for sizes in ({},) if name == "vgb_cases" else ({}, small):
        for k, v in sizes.items():
            monkeypatch.setattr(K11, k, v)
        tables = [K11.vgb_tag_tables(ngroups, pos, gbase)]
        if bounds is not None:
            tables.append(K11.vgb_tag_tables(ngroups.numpy(), pos.numpy(),
                                             gbase.numpy(), bounds))
        # windows that stage and collect nothing, and windows shifted off
        # the rows: every read and write then goes past them
        off = tables[-1]["tiles"].clone()
        off[:, 1:] += torch.tensor([5, 0, 1, 0], dtype=torch.int32)
        none = tables[-1]["tiles"].clone()
        none[:, 2::2] = 0
        tables += [dict(tables[-1], tiles=off), dict(tables[-1], tiles=none)]
        for t in tables:
            got = _emulated_tags(emulated, stream, pos, ngroups, gbase, n_g,
                                 t)
            assert torch.equal(got, want), (name, sizes)


def _emulated_svb(lib, stream, rows, ncol, tables, long_values=None):
    col = torch.full((ncol,), -7, dtype=torch.int32)
    lr, tiles = tables["long_rows"], tables["tiles"]
    assert lib.gab_svb_decode(
        stream.data_ptr(), stream.numel(), *(a.data_ptr() for a in rows),
        rows[0].numel(), lr.data_ptr(), lr.numel(), tiles.data_ptr(),
        tiles.numel() - 1, long_values or K11.SVB_LONG_VALUES,
        col.data_ptr(), col.numel(), 0, None) == 0
    return col


def _svb_rows(adjs):
    """Rows as hybrid lays out its StreamVByte chunks (no count word), one
    after another: (stream, key_start, counts, out_slot, ncol)."""
    chunks = [tvbyte.streamvbyte_encode(np.asarray(a, np.int64),
                                        add_degree=False) for a in adjs]
    bounds = np.cumsum([0] + [len(c) for c in chunks])
    deg = np.array([len(a) for a in adjs])
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return (K12.stream_tensor(b"".join(chunks), "cpu"),
            (i32(bounds[:-1]), i32(deg), i32(np.cumsum(deg) - deg)),
            int(deg.sum()))


def _svb_case(name):
    if name == "hub":
        return _svb_rows(_hub_rows())
    if name == "garbage":
        rng = np.random.default_rng(2)
        # rows past the stream's end, from a negative start, one of 1,500
        # values (three rounds at the shipped sizes), slots past col
        counts = torch.tensor([7, 0, 40, 3, 1500, 77, 5, 600],
                              dtype=torch.int32)
        start = torch.tensor([60, 5, 250, 70, 13, -3, 2990, 101],
                             dtype=torch.int32)
        slot = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        slot[-1] += 10
        data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        return (K12.stream_tensor(data, "cpu"), (start, counts, slot),
                int(counts.sum()))
    if name.startswith("hybrid_"):
        hg = thybrid.encode_graph(_graph(name[7:]), threshold=3)
        high = np.nonzero(hg.degrees >= 3)[0]
        i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
        rp = np.r_[0, np.cumsum(hg.degrees)]
        return (K12.stream_tensor(hg.data, "cpu"),
                (i32(hg.offsets[high]), i32(hg.degrees[high]), i32(rp[high])),
                hg.ne)
    prep = DD.streamvbyte_device_prep(_encoded(name, "streamvbyte"),
                                      device="cpu")
    return (prep["stream"], (prep["key_start"], prep["degrees"],
                             prep["out_slot"]), prep["ne"])


@pytest.mark.parametrize("name", ["rmat9", "hub", "garbage", "hybrid_rmat10"])
def test_svb_decode_source_emulated_equals_plain(emulated, name,
                                                 monkeypatch):
    """svb_decode's kernel against the plain version under the tables
    ``svb_tables`` builds at the shipped sizes, under one tile of every row
    (a warp's: rows crossing from one round into the next inside a tile,
    batches of 32 rows) and, on the handmade rows (a block's 256 host
    threads meet at every barrier), under tables at small sizes (a long row
    from 9 values,
    tiles of 5 quads or 3 rows, so that many rows are long and many tiles
    short) and, on the handmade rows, under a tile a row. The slots that no
    row covers keep what they held."""
    stream, rows, ncol = _svb_case(name)
    want = K11.svb_decode_plain(stream, *rows, torch.full(
        (ncol,), -7, dtype=torch.int32))
    small = {"SVB_LONG_VALUES": 8, "SVB_TILE_QUADS": 5, "SVB_TILE_ROWS": 3}
    for sizes in ({}, small) if name in ("hub", "garbage") else ({},):
        for k, v in sizes.items():
            monkeypatch.setattr(K11, k, v)
        got = _emulated_svb(emulated, stream, rows, ncol,
                            K11.svb_tables(rows[1]))
        assert torch.equal(got, want), (name, sizes)
    n = rows[1].numel()
    none = torch.zeros(0, dtype=torch.int32)
    for tiles in (torch.tensor([0, n], dtype=torch.int32),
                  torch.arange(n + 1, dtype=torch.int32)):
        if name not in ("hub", "garbage") and tiles.numel() > 2:
            continue            # a block of host threads a row
        got = _emulated_svb(emulated, stream, rows, ncol,
                            {"long_rows": none, "tiles": tiles},
                            long_values=2**24)
        assert torch.equal(got, want), (name, tiles.numel())


def test_svb_tables():
    """The long rows widest first; tiles cut where the other rows' first
    quads cross a multiple of SVB_TILE_QUADS or their indices one of
    SVB_TILE_ROWS; the long rows and the empty ones take no quad."""
    counts = np.array([3, 2000, 400, 0, 1800, 900, 1, 4, 1025, 17])
    t = K11.svb_tables(torch.from_numpy(counts.astype(np.int32)))
    assert t["long_rows"].tolist() == [1, 4, 8]
    # quads 1, -, 100, 0, -, 225, 1, 1, -, 5: first quads 0, 1, 1, 101, 101,
    # 101, 326, 327, 328, 328; windows of 112 quads: 0 and 2
    assert t["tiles"].tolist() == [0, 6, 10]
    q = np.where((counts > 1024) | (counts <= 0), 0, (counts + 3) // 4)
    first = np.cumsum(q) - q
    for quads, nrows in ((100, 256), (448, 4), (1, 1)):
        import unittest.mock as um
        with um.patch.object(K11, "SVB_TILE_QUADS", quads), \
                um.patch.object(K11, "SVB_TILE_ROWS", nrows):
            tiles = K11.svb_tables(torch.from_numpy(
                counts.astype(np.int32)))["tiles"].numpy()
        key = first // quads + np.arange(len(counts)) // nrows
        want = np.r_[0, np.flatnonzero(np.diff(key)) + 1, len(counts)]
        np.testing.assert_array_equal(tiles, want)
    assert all(x.dtype == torch.int32 for x in t.values())


@pytest.mark.parametrize("name", ["rmat9", "rmat10", "svb_cases", "vgb_cases",
                                  "wide"])
def test_svb_decode_under_any_tables_equals_jax(name):
    """On the CPU the wrapper takes the plain version whatever tables it is
    given: the StreamVByte decode, through the prep's tables, under none
    and under one tile, equals JAX's device decode; so does hybrid's at
    threshold 2."""
    vg = _encoded(name, "streamvbyte")
    prep = DD.streamvbyte_device_prep(vg, device="cpu")
    assert set(prep["svb_tables"]) == {"long_rows", "tiles"}
    jrp, jcol = JDD.streamvbyte_decode_device(
        _jax_words(vg.data, (-len(vg.data)) % 4 + 8),
        jnp.asarray(prep["word_offsets"].numpy()),
        jnp.asarray(prep["degrees"].numpy()), nv=vg.nv, ne=vg.ne)
    rows = (prep["key_start"], prep["degrees"], prep["out_slot"])
    one = {"long_rows": torch.zeros(0, dtype=torch.int32),
           "tiles": torch.tensor([0, vg.nv], dtype=torch.int32)}
    for tables in (prep["svb_tables"], {}, one):
        col = K11.svb_decode(prep["stream"], *rows, torch.empty(
            vg.ne, dtype=torch.int32), **tables)
        np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    np.testing.assert_array_equal(DD.streamvbyte_device_run(prep).numpy(),
                                  np.asarray(jcol))
    if name == "wide":
        return
    hg = thybrid.encode_graph(_graph(name), threshold=2)
    hp = DD.hybrid_device_prep(hg, device="cpu")
    np.testing.assert_array_equal(
        DD.hybrid_device_run(hp).numpy(),
        JDD.decode_hybrid_device(_jax_hybrid(hg)).col_idx)


def test_vgb_tag_tables():
    """The long rows widest first; tiles cut at the byte boundaries and at
    each long row, which begins its tile and is left out of its extents;
    each tile's bytes from its short rows' first tag to their end (with the
    bounds) or 17 bytes a group on (without), its slots theirs."""
    ng = np.array([1, 300, 2, 0, 900, 5, 300, 1])
    bounds = np.array([0, 10, 5000, 5020, 5024, 30000, 30010, 40000, 40008])
    pos = np.where(ng > 0, bounds[:-1] + 4, 0)
    gbase = np.cumsum(ng) - ng
    t = K11.vgb_tag_tables(ng, pos, gbase, bounds)
    assert t["long_rows"].tolist() == [4, 1, 6]
    assert t["tiles"].tolist() == [[0, 4, 6, 0, 1], [1, 5004, 16, 301, 2],
                                   [4, 0, 0, 0, 0], [5, 30004, 6, 1203, 5],
                                   [6, 0, 0, 0, 0], [7, 40004, 4, 1508, 1],
                                   [8, 0, 0, 0, 0]]
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    d = K11.vgb_tag_tables(i32(ng), i32(pos), i32(gbase))
    assert d["long_rows"].tolist() == [4, 1, 6]
    assert d["tiles"].tolist() == [[0, 4, 40017, 0, 1509],
                                   [8, 0, 0, 0, 0]]
    assert all(x.dtype == torch.int32 for x in (*t.values(), *d.values()))


# ---- on the card -----------------------------------------------------------

def _emulated_values(lib, stream, tagpos, rows, ncol, tables,
                     long_groups=None):
    col = torch.full((ncol,), -7, dtype=torch.int32)
    lr, tiles = tables["long_rows"], tables["tiles"]
    assert lib.gab_vgb_values(
        stream.data_ptr(), stream.numel(), tagpos.data_ptr(), tagpos.numel(),
        *(a.data_ptr() for a in rows), rows[0].numel(), lr.data_ptr(),
        lr.numel(), tiles.data_ptr(), tiles.shape[0] - 1,
        long_groups or K11.VGB_LONG_GROUPS, col.data_ptr(), col.numel(), 0,
        None) == 0
    return col


def _value_case(name):
    """(stream, tagpos, (gbase, counts, out_slot), ncol) of a VarintGB
    decode's vgb_values: a graph's through its prep, the handmade rows, or
    random bytes under random tag positions (negative ones, ones past the
    stream and past tagpos among them) with a slot past col."""
    if name == "garbage":
        rng = np.random.default_rng(3)
        counts = torch.tensor([7, 0, 40, 3, 1500, 77, 5, 600, 1],
                              dtype=torch.int32)
        ng = (counts + 3) // 4
        gbase = torch.cumsum(ng, 0, dtype=torch.int32) - ng
        slot = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        slot[-1] += 5
        n_g = int(ng.sum()) - 3
        tagpos = torch.from_numpy(rng.integers(-20, 3100, n_g).astype(
            np.int32))
        data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        return (K12.stream_tensor(data, "cpu"), tagpos, (gbase, counts, slot),
                int(counts.sum()))
    if name == "hub":
        stream, pos, ngroups, gbase, n_g, _ = _vgb_rows(_hub_rows())
        counts = torch.tensor([len(a) for a in _hub_rows()], dtype=torch.int32)
    else:
        vg = _encoded(name, "varintgb")
        prep = DD.varintgb_device_prep(vg, device="cpu")
        stream, pos, ngroups, gbase, n_g = (prep["stream"], prep["pos"],
                                            prep["ngroups"], prep["gbase"],
                                            prep["n_g"])
        counts = prep["counts"]
    tagpos = K11.vgb_tags_plain(stream, pos, ngroups, gbase, n_g)
    slot = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return stream, tagpos, (gbase, counts, slot), int(counts.sum())


@pytest.mark.parametrize("name", ["rmat9", "rmat10", "vgb_cases", "hub",
                                  "garbage"])
def test_vgb_values_source_emulated_equals_plain(emulated, name,
                                                 monkeypatch):
    """vgb_values' kernel against the plain version, and so against JAX's
    ``_vgb_flat_values`` (test_vgb_plain_passes_equal_jax_tag_chain_and_
    flat_values), under the tables vgb_value_tables builds at the shipped
    sizes (the prep's, and what the wrapper builds without them); on all but
    the 70,000 rows of vgb_cases (a block's 256 host threads meet at every
    barrier) also under tiny tables (a long row from 9 groups, tiles of 5
    groups or 3 rows), under tables whose first group and slot are shifted
    off the rows (rows that leave the staged groups, ids that leave the
    collected slots, decoded from the stream and written directly), under
    tables that stage and collect nothing, and under one tile of every row
    (rows past a block's first 256 decoded by their threads). The slots no
    row covers keep what they held; the hub's row of 12,000 ids takes
    several rounds of a long row's block."""
    stream, tagpos, rows, ncol = _value_case(name)
    want = K11.vgb_values_plain(stream, tagpos, *rows, torch.full(
        (ncol,), -7, dtype=torch.int32))
    tables = [K11.vgb_value_tables(*rows)]
    if name != "vgb_cases":
        with monkeypatch.context() as m:
            for k, v in {"VGB_LONG_GROUPS": 8, "VGB_VALUE_TILE_GROUPS": 5,
                         "VGB_VALUE_TILE_ROWS": 3}.items():
                m.setattr(K11, k, v)
            tiny = K11.vgb_value_tables(*rows)
            assert torch.equal(_emulated_values(
                emulated, stream, tagpos, rows, ncol, tiny, 8), want)
        off = tables[0]["tiles"].clone()
        off[:-1, 1:] += torch.tensor([5, 0, 1], dtype=torch.int32)
        none = tables[0]["tiles"].clone()
        none[:-1, 1:] = torch.tensor([2**30, 0, 2**30], dtype=torch.int32)
        n = rows[0].numel()
        one = torch.tensor([[0, 0, 0, 0], [n, 0, 0, 0]], dtype=torch.int32)
        tables += [dict(tables[0], tiles=off), dict(tables[0], tiles=none),
                   dict(tables[0], tiles=one)]
    for t in tables:
        got = _emulated_values(emulated, stream, tagpos, rows, ncol, t)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("name", ["rmat9", "hub", "garbage"])
def test_vgb_values_source_emulated_with_small_spans(emulated_small, name):
    """Under the shipped tables, the kernel with a tile of 256 groups and
    48 staged bytes: rows past the tile's groups decoded by their threads,
    groups past the staged bytes read from the stream, long rows in many
    rounds; still the plain version's ids."""
    stream, tagpos, rows, ncol = _value_case(name)
    want = K11.vgb_values_plain(stream, tagpos, *rows, torch.full(
        (ncol,), -7, dtype=torch.int32))
    got = _emulated_values(emulated_small, stream, tagpos, rows, ncol,
                           K11.vgb_value_tables(*rows))
    assert torch.equal(got, want), name


def test_vgb_value_tables():
    """The long rows widest first; tiles cut where the short rows' first
    groups, counted over them, cross a multiple of VGB_VALUE_TILE_GROUPS,
    the rows' indices one of VGB_VALUE_TILE_ROWS, and at each long row,
    which begins its tile and is left out of its extents (first group,
    groups, first slot); the prep's tables are these, and each tile's
    groups fit the kernel's 1,024."""
    counts = np.array([3, 2000, 400, 0, 1800, 900, 1, 4, 1025, 17, 30])
    ng = (counts + 3) // 4
    gbase = np.cumsum(ng) - ng
    slot = np.cumsum(counts) - counts
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    t = K11.vgb_value_tables(i32(gbase), i32(counts), i32(slot))
    assert t["long_rows"].tolist() == [1, 4, 8]
    # groups 1, 500 (long), 100, 0, 450 (long), 225, 1, 1, 257 (long), 5,
    # 8; the short rows' first groups counted over them 0, -, 1, 101, -,
    # 101, 326, 327, -, 328, 333
    assert t["tiles"].tolist() == [[0, 0, 1, 0], [1, 501, 100, 2003],
                                   [4, 1051, 227, 4203], [8, 1535, 13, 6133],
                                   [11, 0, 0, 0]]
    long = ng > K11.VGB_LONG_GROUPS
    short = (ng > 0) & ~long
    q = np.where(short, ng, 0)
    for groups, nrows in ((100, 256), (5, 2), (768, 1), (768, 256)):
        with mock.patch.multiple(K11, VGB_VALUE_TILE_GROUPS=groups,
                                 VGB_VALUE_TILE_ROWS=nrows):
            tiles = K11.vgb_value_tables(i32(gbase), i32(counts),
                                         i32(slot))["tiles"].numpy()
        key = ((np.cumsum(q) - q) // groups + np.arange(len(ng)) // nrows
               + np.cumsum(long))
        ptr = np.r_[0, np.flatnonzero(np.diff(key)) + 1, len(ng)]
        np.testing.assert_array_equal(tiles[:, 0], ptr)
        for k in range(len(ptr) - 1):
            sel = np.flatnonzero(short[ptr[k]:ptr[k + 1]]) + ptr[k]
            want = ((gbase[sel].min(),
                     (gbase + ng)[sel].max() - gbase[sel].min(),
                     slot[sel].min()) if len(sel) else (0, 0, 0))
            assert tuple(tiles[k, 1:]) == want
    vg = _encoded("rmat10", "varintgb")
    prep = DD.varintgb_device_prep(vg, device="cpu")
    want = K11.vgb_value_tables(prep["gbase"], prep["counts"],
                                prep["out_slot"])
    for k in ("long_rows", "tiles"):
        assert torch.equal(prep["value_tables"][k], want[k])
        assert prep["value_tables"][k].dtype == torch.int32
    tiles = want["tiles"].long()
    for (lo, g0, g_len, _), hi in zip(tiles[:-1].tolist(),
                                      tiles[1:, 0].tolist()):
        g = prep["ngroups"][lo:hi].long()
        keep = (g > 0) & (g <= K11.VGB_LONG_GROUPS)
        if keep.any():
            assert int((prep["gbase"][lo:hi].long() + g)[keep].max()) - g0 \
                == g_len <= 1024


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/vbyte_decode.cu "
                    "have no CPU route")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat10", "svb_cases", "vgb_cases"])
def test_kernels_match_plain_on_cuda(name):
    """Each K11 kernel against its plain version on the preps' rows on the
    card, exactly, and the three decodes against the graph."""
    _need_cuda()
    g = _graph(name)
    svb = DD.streamvbyte_device_prep(_encoded(name, "streamvbyte"),
                                     device="cuda")
    rows = (svb["word_offsets"][:g.nv] * 4 + 4, svb["degrees"],
            torch.cumsum(svb["degrees"], 0, dtype=torch.int32)
            - svb["degrees"])
    got = K11.svb_decode(svb["stream"], *rows, torch.full(
        (g.ne,), -1, dtype=torch.int32, device="cuda"))
    assert torch.equal(got, K11.svb_decode_plain(
        svb["stream"], *rows, torch.zeros_like(got)))
    assert torch.equal(K11.svb_decode(svb["stream"], *rows, torch.full(
        (g.ne,), -1, dtype=torch.int32, device="cuda"), **svb["svb_tables"]),
        got)
    vgb = DD.varintgb_device_prep(_encoded(name, "varintgb"), device="cuda")
    chain = (vgb["pos"], vgb["ngroups"], vgb["gbase"], vgb["n_g"])
    tags = K11.vgb_tags(vgb["stream"], *chain)
    assert torch.equal(tags, K11.vgb_tags_plain(vgb["stream"], *chain))
    assert torch.equal(K11.vgb_tags(vgb["stream"], *chain,
                                    **vgb["tag_tables"]), tags)
    rows = (vgb["gbase"], vgb["counts"], vgb["out_slot"])
    got = K11.vgb_values(vgb["stream"], tags, *rows, torch.full(
        (g.ne,), -1, dtype=torch.int32, device="cuda"))
    assert torch.equal(got, K11.vgb_values_plain(
        vgb["stream"], tags, *rows, torch.zeros_like(got)))
    _same(DD.decode_graph_device(_encoded(name, "streamvbyte"),
                                 device="cuda"), g)
    _same(DD.varintgb_decode_device(_encoded(name, "varintgb"),
                                    device="cuda"), g)
    threshold = 2 if name.endswith("_cases") else 4   # repeated ids: Q3-2
    _same(DD.decode_hybrid_device(thybrid.encode_graph(g, threshold=threshold),
                                  device="cuda"), g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat10", "svb_cases", "hub", "garbage",
                                  "hybrid_rmat10"])
def test_svb_decode_routes_on_cuda(name, monkeypatch):
    """svb_decode's long rows (a block each, in rounds) and tiles on the
    card against the plain version, under the tables svb_tables builds at
    the shipped sizes and at small ones, and under one tile of every row."""
    _need_cuda()
    stream, rows, ncol = _svb_case(name)
    stream = stream.cuda()
    rows = tuple(a.cuda() for a in rows)
    want = K11.svb_decode_plain(stream, *rows, torch.full(
        (ncol,), -7, dtype=torch.int32, device="cuda"))
    for sizes in ({}, {"SVB_LONG_VALUES": 8, "SVB_TILE_QUADS": 5,
                       "SVB_TILE_ROWS": 3}):
        for k, v in sizes.items():
            monkeypatch.setattr(K11, k, v)
        col = torch.full((ncol,), -7, dtype=torch.int32, device="cuda")
        assert torch.equal(K11.svb_decode(stream, *rows, col), want), sizes
    monkeypatch.setattr(K11, "SVB_LONG_VALUES", 2**24)
    one = {"long_rows": torch.zeros(0, dtype=torch.int32, device="cuda"),
           "tiles": torch.tensor([0, rows[0].numel()], dtype=torch.int32,
                                 device="cuda")}
    col = torch.full((ncol,), -7, dtype=torch.int32, device="cuda")
    assert torch.equal(K11.svb_decode(stream, *rows, col, **one), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat10", "vgb_cases", "hub", "garbage"])
def test_vgb_values_routes_on_cuda(name, monkeypatch):
    """vgb_values' long rows (a block each, in rounds) and tiles on the card
    against the plain version, under the tables vgb_value_tables builds (by
    the wrapper, and given), at small sizes, shifted off the rows, staging
    and collecting nothing, and as one tile of every row."""
    _need_cuda()
    stream, tagpos, rows, ncol = _value_case(name)
    stream, tagpos = stream.cuda(), tagpos.cuda()
    rows = tuple(a.cuda() for a in rows)
    want = K11.vgb_values_plain(stream, tagpos, *rows, torch.full(
        (ncol,), -7, dtype=torch.int32, device="cuda"))

    def check(**tables):
        col = torch.full((ncol,), -7, dtype=torch.int32, device="cuda")
        got = K11.vgb_values(stream, tagpos, *rows, col, **tables)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, tables)

    check()
    t = K11.vgb_value_tables(*rows)
    check(**t)
    off = t["tiles"].clone()
    off[:-1, 1:] += torch.tensor([5, 0, 1], dtype=torch.int32, device="cuda")
    check(long_rows=t["long_rows"], tiles=off)
    none = t["tiles"].clone()
    none[:-1, 1:] = torch.tensor([2**30, 0, 2**30], dtype=torch.int32,
                                 device="cuda")
    check(long_rows=t["long_rows"], tiles=none)
    n = rows[0].numel()
    check(long_rows=t["long_rows"], tiles=torch.tensor(
        [[0, 0, 0, 0], [n, 0, 0, 0]], dtype=torch.int32, device="cuda"))
    for k, v in {"VGB_LONG_GROUPS": 8, "VGB_VALUE_TILE_GROUPS": 5,
                 "VGB_VALUE_TILE_ROWS": 3}.items():
        monkeypatch.setattr(K11, k, v)
    check()


@pytest.mark.cuda
def test_kernels_match_plain_on_a_stream_that_does_not_parse():
    _need_cuda()
    rng = np.random.default_rng(0)
    stream = K12.stream_tensor(
        rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), "cuda")
    counts = torch.tensor([7, 0, 40, 3, 77], dtype=torch.int32, device="cuda")
    start = torch.tensor([60, 5, 250, 70, -3], dtype=torch.int32,
                         device="cuda")
    slot = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    n = int(counts.sum())
    got = K11.svb_decode(stream, start, counts, slot, torch.zeros(
        n, dtype=torch.int32, device="cuda"))
    assert torch.equal(got, K11.svb_decode_plain(
        stream, start, counts, slot, torch.zeros_like(got)))
    ng = (counts + 3) // 4
    gb = torch.cumsum(ng, 0, dtype=torch.int32) - ng
    tags = K11.vgb_tags(stream, start, ng, gb, int(ng.sum()))
    assert torch.equal(tags, K11.vgb_tags_plain(stream, start, ng, gb,
                                                int(ng.sum())))
    got = K11.vgb_values(stream, tags, gb, counts, slot, torch.zeros(
        n, dtype=torch.int32, device="cuda"))
    assert torch.equal(got, K11.vgb_values_plain(
        stream, tags, gb, counts, slot, torch.zeros_like(got)))
