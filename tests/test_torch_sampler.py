"""The port's GraphSAINT sampler and subgraph padding against the JAX
package's: every array bit-equal (same dtype, same values), since both
packages' sampled steps are compared on them array by array.

``jax_native`` is the fixture of every port test that holds the port's
C++ host kernels against the JAX package's native library; the other
test files import it from here."""

import shutil

import numpy as np
import pytest

from graphaibench_tpu import native as jnative
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as jT
from graphaibench_tpu.nn import model as jm
from graphaibench_tpu.nn import sampler as jsampler
from graphaibench_tpu_torch import native as tnative
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as tT
from graphaibench_tpu_torch.nn import model as tm
from graphaibench_tpu_torch.nn import sampler as tsampler

SEEDS = [0, 1, 2, 7, 12345]


@pytest.fixture
def jax_native(tmp_path_factory, monkeypatch):
    return load_jax_native(tmp_path_factory, monkeypatch)


def load_jax_native(tmp_path_factory, monkeypatch):
    """The JAX package's native library, loaded in this process from a
    build of its own. The package builds it at first use into a cache
    that every process shares, through one fixed temporary file name:
    when several test processes start on an empty cache at once, the
    ones that lose the race get no library for the rest of their life
    and take the numpy routes, whose sampler draws other vertices than
    the C++ one the port takes. Fails, rather than skips, where g++ is
    present and the library still does not load."""
    cache = tmp_path_factory.getbasetemp() / "jax_native"
    cache.mkdir(exist_ok=True)
    monkeypatch.setenv("GAB_NATIVE_CACHE", str(cache))
    monkeypatch.delenv("GAB_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    if jnative.get_lib() is None:
        if shutil.which("g++") is None:
            pytest.skip("no g++: the JAX package's native library is not "
                        "built on this host")
        pytest.fail("g++ is on this host: the JAX package's native library "
                    "must load")
    return jnative


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _samplers(scale=11, frontier=None):
    tg, jg = tgen.rmat(scale, 8, seed=1), jgen.rmat(scale, 8, seed=1)
    mask = (np.arange(tg.nv) % 4 != 0).astype(np.uint8)
    kw = {} if frontier is None else {"frontier_size": frontier}
    return (tsampler.SaintSampler(tg, tT.masked_subgraph(tg, mask), mask, **kw),
            jsampler.SaintSampler(jg, jT.masked_subgraph(jg, mask), mask, **kw))


def test_constants_match():
    assert tsampler.SAMPLE_CLIP == jsampler.SAMPLE_CLIP
    assert tsampler.DEFAULT_FRONTIER == jsampler.DEFAULT_FRONTIER


@pytest.mark.parametrize("n", [64, 700])
@pytest.mark.parametrize("seed", SEEDS)
def test_native_saint_sample_bit_equal(seed, n, jax_native):
    """The C++ frontier sampler with its xorshift64 stream, n below and
    above the frontier size 200."""
    assert tnative.available()
    ts, js = _samplers(frontier=200)
    args = (ts.masked.row_ptr, ts.masked.col_idx,
            ts.train_nodes.astype(np.int64), n, min(200, n),
            tsampler.SAMPLE_CLIP, seed)
    t = tnative.saint_sample(*args)
    _same(t, jnative.saint_sample(*args))
    _same(ts.select_vertices(n, seed), js.select_vertices(n, seed))
    assert 0 < len(t) <= n and np.all(np.diff(t) > 0)


@pytest.mark.parametrize("n", [64, 300])
@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_route_bit_equal(seed, n, monkeypatch):
    """The route for a host without g++ against the JAX package's, which
    takes it when its native library is unavailable."""
    ts, js = _samplers(frontier=100)
    monkeypatch.setattr(jnative, "available", lambda: False)
    _same(ts.select_vertices_numpy(n, seed), js.select_vertices(n, seed))
    monkeypatch.setattr(tnative, "saint_sample", lambda *a: None)
    _same(ts.select_vertices(n, seed), js.select_vertices(n, seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_subgraph_bit_equal(seed):
    ts, js = _samplers()
    (tsub, tl2g, tmask), (jsub, jl2g, jmask) = (
        s.generate_subgraph(400, seed) for s in (ts, js))
    _same(tsub.row_ptr, jsub.row_ptr, "row_ptr")
    _same(tsub.col_idx, jsub.col_idx, "col_idx")
    _same(tl2g, jl2g, "l2g")
    _same(tmask, jmask, "mask")


def test_sampler_rejects_an_empty_train_mask():
    tg = tgen.rmat(6, 4, seed=0)
    with pytest.raises(ValueError, match="train mask"):
        tsampler.SaintSampler(tg, tg, np.zeros(tg.nv, np.uint8))


@pytest.mark.parametrize("e_pad", [64, 1 << 15])
@pytest.mark.parametrize("arch", ["gcn", "sage", "gat"])
def test_pad_subgraph_bit_equal(arch, e_pad):
    """Every key of the padded step arrays; an ``e_pad`` of 64 is smaller
    than the sample's edge count and has to grow."""
    ts, js = _samplers()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((ts.full.nv, 12)).astype(np.float32)
    labels = rng.integers(0, 5, ts.full.nv).astype(np.int32)
    t = tm.pad_subgraph(ts, arch, 400, 3, 400, e_pad, feats, labels)
    j = jm.pad_subgraph(js, arch, 400, 3, 400, e_pad, feats, labels)
    assert sorted(t) == sorted(j)
    for key in j:
        if isinstance(j[key], np.ndarray):
            _same(t[key], j[key], key)
        else:
            assert t[key] == j[key], key
    assert (t["e_pad"] > 64) and (t["e_pad"] == e_pad or e_pad == 64)
    assert t["e_pad"] % 64 == 0 and len(t["es"]) == t["e_pad"]
