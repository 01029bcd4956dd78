"""The port's host codecs of compressed graphs (``graphaibench_tpu_torch/
compress``: ``unary``, ``vbyte``, ``cgr`` with its native encoder and
decoder, ``hybrid``, ``cli``) held against the JAX package's on the CPU.

Every encoding must be byte-equal to the JAX package's, both packages'
decoders must give back the graph, files written by either package's
``save_compressed`` must load in the other's, and the port's ``compress``,
``decompress``, ``verify`` and ``info`` commands must do what the JAX CLI's
do. Graphs are built by each package's own generators from the same
parameters and held equal here.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from graphaibench_tpu import cli as jcli
from graphaibench_tpu import native as jnative
from graphaibench_tpu.compress import cgr as jcgr
from graphaibench_tpu.compress import cli as jccli
from graphaibench_tpu.compress import hybrid as jhybrid
from graphaibench_tpu.compress import unary as junary
from graphaibench_tpu.compress import vbyte as jvbyte
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch import native as tnative
from graphaibench_tpu_torch.compress import cgr as tcgr
from graphaibench_tpu_torch.compress import cli as tccli
from graphaibench_tpu_torch.compress import hybrid as thybrid
from graphaibench_tpu_torch.compress import unary as tunary
from graphaibench_tpu_torch.compress import vbyte as tvbyte
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import transforms as T
from test_torch_sampler import jax_native  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runs(gen, tr, csr):
    """300 vertices, each with a run of up to 11 consecutive successors
    (intervals) and up to 5 scattered neighbours (residuals), cleaned."""
    rng = np.random.default_rng(7)
    src, dst = [], []
    nv = 300
    for v in range(nv):
        for t in range(int(rng.integers(0, 12))):
            if v + 1 + t < nv:
                src.append(v)
                dst.append(v + 1 + t)
        for _ in range(int(rng.integers(0, 6))):
            src.append(v)
            dst.append(int(rng.integers(0, nv)))
    return tr.sort_and_clean(csr.from_edges(np.asarray(src), np.asarray(dst),
                                            nv))


GRAPHS = {
    "uniform": lambda gen, tr, csr: gen.uniform_random(150, 600, seed=2),
    "rmat9": lambda gen, tr, csr: tr.sort_and_clean(gen.rmat(9, 8, seed=1)),
    "runs": _runs,
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


def _same_csr(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a.row_ptr), np.asarray(b.row_ptr),
                                  err_msg=what)
    np.testing.assert_array_equal(np.asarray(a.col_idx), np.asarray(b.col_idx),
                                  err_msg=what)


# ---- unary codes -----------------------------------------------------------

CODE_VALUES = [0, 1, 2, 3, 7, 8, 100, 1023, 1024, 123456, 2**30, 2**31 - 1,
               2**31, 2**32 - 1, 2**32, 2**33 + 5, 2**40 + 3]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_zeta_codes_byte_equal_and_read_back(k):
    """gamma (k = 1) and zeta_k codes of values up to 2^40, codes of 32
    bits and more among them: the same bits, the same lengths, read back
    by either package."""
    tw, jw = tunary.BitWriter(), junary.BitWriter()
    for x in CODE_VALUES:
        tunary.write_zeta(tw, x, k)
        junary.write_zeta(jw, x, k)
        assert tunary.zeta_len(x, k) == junary.zeta_len(x, k)
        assert tunary.gamma_len(x) == junary.gamma_len(x)
    assert tw.bit_length == jw.bit_length
    assert tw.getvalue() == jw.getvalue()
    assert max(tunary.zeta_len(x, k) for x in CODE_VALUES) >= 32
    tr, jr = tunary.BitReader(jw.getvalue()), junary.BitReader(tw.getvalue())
    assert [tunary.read_zeta(tr, k) for _ in CODE_VALUES] == CODE_VALUES
    assert [junary.read_zeta(jr, k) for _ in CODE_VALUES] == CODE_VALUES


def test_gamma_alignment_and_signed_deltas():
    tw, jw = tunary.BitWriter(), junary.BitWriter()
    for w in (tw, jw):
        w.write(5, 3)
    tunary.write_gamma(tw, 9)
    junary.write_gamma(jw, 9)
    for unit in (8, 32):
        tw.align(unit)
        jw.align(unit)
        assert tw.getvalue() == jw.getvalue()
        assert tw.bit_length % unit == 0
    for x in range(-300, 300):
        assert tunary.int_2_nat(x) == junary.int_2_nat(x)
        assert tunary.nat_2_int(tunary.int_2_nat(x)) == x


# ---- VByte -----------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["streamvbyte", "varintgb"])
@pytest.mark.parametrize("name", ["uniform", "rmat9"])
def test_vbyte_byte_equal_and_decodes(scheme, name):
    g, jg = _pair(name)
    tv, jv = tvbyte.encode_graph(g, scheme), jvbyte.encode_graph(jg, scheme)
    assert tv.data == jv.data and len(tv.data) % 4 == 0
    assert np.array_equal(tv.offsets, jv.offsets)
    assert np.array_equal(tv.degrees, jv.degrees)
    assert tv.compression_ratio() == jv.compression_ratio()
    _same_csr(tvbyte.decode_graph(tv), g, scheme)
    for v in range(0, g.nv, 7):
        assert np.array_equal(tvbyte.decode_vertex(tv, v),
                              jvbyte.decode_vertex(jv, v))


@pytest.mark.parametrize("scheme", ["streamvbyte", "varintgb"])
def test_vbyte_lists_of_every_byte_length(scheme):
    """Gaps of 1, 2, 3 and 4 bytes, with and without the count word."""
    adj = np.asarray([3, 300, 70_000, 20_000_000, 2**31 - 2], np.int64)
    enc_t, dec_t = tvbyte._CODECS[scheme]
    enc_j, dec_j = jvbyte._CODECS[scheme]
    for add_degree in (True, False):
        bt = enc_t(adj, add_degree=add_degree)
        assert bt == enc_j(adj, add_degree=add_degree)
        count = None if add_degree else len(adj)
        assert np.array_equal(dec_t(bt, 0, count), dec_j(bt, 0, count))
        assert np.array_equal(dec_t(bt, 0, count), adj.astype(np.int32))


# ---- CGR -------------------------------------------------------------------

# tests/test_compress.py's CGR configs (its round trip, :54-63, and the
# device decode's, :392-410, with and without intervals) and the segment
# lengths 0, 32, 64 and 256
CGR_CONFIGS = {
    "default": {},
    "zeta1": dict(zeta_k=1),
    "zeta3_seg128": dict(zeta_k=3, res_seg_len=128),
    "unary": dict(res_seg_len=0),
    "interval": dict(use_interval=True),
    "interval_unary_deg": dict(use_interval=True, res_seg_len=0,
                               add_degree=True),
    "byte": dict(alignment="byte"),
    "word_interval": dict(alignment="word", use_interval=True),
    "zeta3": dict(zeta_k=3),
    "word": dict(alignment="word"),
    "add_degree": dict(add_degree=True),
    "seg64": dict(res_seg_len=64),
    "seg32": dict(res_seg_len=32),
    "itv64": dict(use_interval=True, itv_seg_len=64),
    "itv64_deg": dict(use_interval=True, itv_seg_len=64, add_degree=True),
    "itv128": dict(use_interval=True, itv_seg_len=128),
    "itv64_min2": dict(use_interval=True, itv_seg_len=64, min_itv_len=2),
    "itv64_zeta3": dict(use_interval=True, itv_seg_len=64, zeta_k=3),
    "itv64_byte": dict(use_interval=True, itv_seg_len=64, alignment="byte"),
}


@pytest.mark.parametrize("cfg", sorted(CGR_CONFIGS))
@pytest.mark.parametrize("name", ["uniform", "rmat9", "runs"])
def test_cgr_byte_equal_and_decodes(name, cfg, jax_native):  # noqa: F811
    """Both packages' native encoders give the same stream and offsets; the
    port's decoder (native with degrees, Python without) and the JAX
    package's give back the graph from either stream."""
    g, jg = _pair(name)
    kw = CGR_CONFIGS[cfg]
    tc = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
    jc = jcgr.encode_graph(jg, jcgr.CgrConfig(**kw))
    assert tc.data == jc.data, cfg
    assert np.array_equal(tc.offsets, jc.offsets)
    assert tc.compression_ratio() == jc.compression_ratio()
    _same_csr(tcgr.decode_graph(tc), g, "python route")
    _same_csr(tcgr.decode_graph(tc, degrees=g.degrees()), g, "native route")
    for v in range(0, g.nv, 11):
        assert np.array_equal(tcgr.decode_vertex(tc, v),
                              jcgr.decode_vertex(jc, v))


def _python_route(monkeypatch):
    """Both packages without their native library: the Python encoders."""
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


@pytest.mark.parametrize("cfg", ["default", "zeta1", "itv64_zeta3",
                                 "word_interval", "interval_unary_deg",
                                 "add_degree", "seg32"])
def test_cgr_native_route_equals_python_route(cfg, jax_native,  # noqa: F811
                                              monkeypatch):
    g, jg = _pair("runs")
    kw = CGR_CONFIGS[cfg]
    assert tnative.available()
    native = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
    jnat = jcgr.encode_graph(jg, jcgr.CgrConfig(**kw))
    _python_route(monkeypatch)
    assert not tnative.available() and not jnative.available()
    python = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
    jpy = jcgr.encode_graph(jg, jcgr.CgrConfig(**kw))
    assert native.data == python.data == jnat.data == jpy.data
    assert np.array_equal(native.offsets, python.offsets)
    assert np.array_equal(python.offsets, jpy.offsets)
    _same_csr(tcgr.decode_graph(python, degrees=g.degrees()), g)


def test_cgr_refuses_unsorted_rows_and_native_decode_checks_degrees():
    g, _ = _pair("uniform")
    col = g.col_idx.copy()
    lo, hi = g.row_ptr[3], g.row_ptr[4]
    col[lo:hi] = col[lo:hi][::-1]
    bad = tcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=col)
    with pytest.raises(ValueError, match="strictly increasing"):
        tcgr.encode_graph(bad)
    cg = tcgr.encode_graph(g)
    wrong = g.degrees().astype(np.int64)
    wrong[5] += 1
    wrong[6] -= 1
    with pytest.raises(ValueError, match="another degree"):
        tcgr.decode_graph(cg, degrees=wrong)


# ---- hybrid ----------------------------------------------------------------

@pytest.mark.parametrize("threshold", [4, 8, 32, 10**9])
def test_hybrid_byte_equal_and_decodes(threshold):
    g, jg = _pair("rmat9")
    th = thybrid.encode_graph(g, threshold=threshold)
    jh = jhybrid.encode_graph(jg, threshold=threshold)
    assert th.data == jh.data
    assert np.array_equal(th.offsets, jh.offsets)
    assert np.array_equal(th.degrees, jh.degrees)
    _same_csr(thybrid.decode_graph(th), g, f"threshold {threshold}")
    for v in range(0, g.nv, 13):
        assert np.array_equal(thybrid.decode_vertex(th, v),
                              jhybrid.decode_vertex(jh, v))


# ---- files across packages -------------------------------------------------

SCHEMES = {
    "cgr": lambda c, g: c[0].encode_graph(g, c[0].CgrConfig()),
    "cgr_word_itv": lambda c, g: c[0].encode_graph(
        g, c[0].CgrConfig(alignment="word", use_interval=True)),
    "streamvbyte": lambda c, g: c[1].encode_graph(g, "streamvbyte"),
    "varintgb": lambda c, g: c[1].encode_graph(g, "varintgb"),
    "hybrid": lambda c, g: c[2].encode_graph(g, threshold=8),
}
# -p needs a word-aligned stream (compressor.cc:109)
WORD_ALIGNED = ("cgr_word_itv", "streamvbyte", "varintgb")


@pytest.mark.parametrize("scheme,permuted", [
    *((s, False) for s in sorted(SCHEMES)), *((s, True) for s in WORD_ALIGNED)])
def test_saved_files_equal_and_load_across_packages(scheme, permuted,
                                                    tmp_path):
    g, jg = _pair("runs")
    tobj = SCHEMES[scheme]((tcgr, tvbyte, thybrid), g)
    jobj = SCHEMES[scheme]((jcgr, jvbyte, jhybrid), jg)
    tpre, jpre = str(tmp_path / "t" / "g"), str(tmp_path / "j" / "g")
    tccli.save_compressed(tobj, tpre, permuted=permuted)
    jccli.save_compressed(jobj, jpre, permuted=permuted)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for n in names:
        assert filecmp.cmp(tmp_path / "t" / n, tmp_path / "j" / n,
                           shallow=False), n
    # the port loads the JAX package's files, and the other way round
    from_j, from_t = tccli.load_compressed(jpre), jccli.load_compressed(tpre)
    assert from_j.data == tobj.data and from_t.data == jobj.data
    _same_csr(tccli.decode_any(from_j), g, "port decodes JAX's file")
    _same_csr(jccli.decode_any(from_t), g, "JAX decodes the port's file")


def test_permutation_is_an_involution_and_needs_words():
    data = bytes(range(16))
    once = tccli.permute_bytes_by_word(data)
    assert once == jccli.permute_bytes_by_word(data)
    assert once[:4] == bytes([3, 2, 1, 0])
    assert tccli.permute_bytes_by_word(once) == data
    with pytest.raises(AssertionError):
        tccli.permute_bytes_by_word(b"abc")


# ---- the commands ----------------------------------------------------------

def _cli(*args):
    return subprocess.run([sys.executable, "-m", "graphaibench_tpu_torch.cli",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("compress") / "rmat9")
    tio.save_graph(tgen.rmat(9, 8, seed=0), path)
    return path


@pytest.mark.parametrize("flags", [
    ("-s", "cgr"), ("-s", "cgr", "-i", "-z", "3"),
    ("-s", "cgr", "-a", "word", "-p"), ("-s", "streamvbyte"),
    ("-s", "varintgb", "-p"), ("-s", "hybrid", "-t", "8")])
def test_compress_commands_in_a_subprocess(dataset, flags, tmp_path, capsys):
    """``cli compress compress|verify|decompress|info``: the files and the
    lines of the JAX CLI's ``compress`` route, the graph back, and the
    top-level ``info`` on the prefix as the JAX CLI prints it."""
    prefix, jprefix = str(tmp_path / "t" / "g"), str(tmp_path / "j" / "g")
    r = _cli("compress", "compress", dataset, prefix, *flags)
    assert r.returncode == 0, r.stderr
    assert jccli.main(["compress", dataset, jprefix, *flags]) == 0
    assert r.stdout == capsys.readouterr().out
    for n in sorted(os.listdir(tmp_path / "t")):
        assert filecmp.cmp(tmp_path / "t" / n, tmp_path / "j" / n,
                           shallow=False), n
    r = _cli("compress", "verify", dataset, prefix)
    assert r.returncode == 0 and r.stdout.strip() == "Correct", r.stderr
    out = str(tmp_path / "out")
    r = _cli("compress", "decompress", prefix, out)
    assert r.returncode == 0, r.stderr
    _same_csr(tio.load_graph(out), tio.load_graph(dataset))
    for argv, jrun in ((("compress", "info", prefix),
                        lambda: jccli.main(["info", prefix])),
                       (("info", prefix), lambda: jcli.cmd_info([prefix]))):
        r = _cli(*argv)
        assert r.returncode == 0, r.stderr
        capsys.readouterr()
        assert jrun() == 0
        assert r.stdout == capsys.readouterr().out


def test_compress_command_refusals(dataset, tmp_path):
    r = _cli("compress", "compress", dataset, str(tmp_path / "g"), "-p")
    assert r.returncode != 0 and "word alignment" in r.stderr
    r = _cli("compress")
    assert r.returncode == 2 and "usage" in r.stdout
    r = _cli("compress", "bogus")
    assert r.returncode == 2 and "unknown command" in r.stdout
    prefix = str(tmp_path / "v" / "g")
    assert _cli("compress", "compress", dataset, prefix).returncode == 0
    other = str(tmp_path / "other")
    tio.save_graph(tgen.rmat(9, 8, seed=1), other)
    r = _cli("compress", "verify", other, prefix)
    assert r.returncode == 1 and r.stdout.startswith("Wrong (vertex ")
