"""The int32 audit of the kernel sources at the products shape.

``rmat(21, 26)`` symmetrised with self-loops has nv = 2,097,152 and about
105 M edges; the widest feature matrix of its trainer runs is F = 256. Ids,
row pointers, edge ids and slot indices stay int32 (each below 2^31, the
wrappers refuse graphs of 2^31 edges), but a slot's or a row's offset
multiplied by a feature width, or a virtual row by its bucket's width, can
pass 2^31: slot x 128 does from 16.8 M slots on. The kernels form every
such product in 64 bits. This file holds them to that: every product by a
feature width (``f``, ``f_v``, ``f4``) in ``csrc/`` has a 64-bit left
operand (``static_cast<int64_t>(...)``), every product by a bucket width
has the virtual row ``r`` (an ``int64_t`` wherever it is declared), and the
numpy emulation of the largest offsets at the products shape shows that the
64-bit forms are right where 32 bits would wrap.
"""

import re

import numpy as np
import pytest

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops.device_graph import ELL_SPLIT

SOURCES = sorted(p for p in _build.CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
NV = 1 << 21                   # rmat(21, 26)
NE = 105_000_000               # its directed edges with self-loops, rounded up
F_MAX = 256


def _code(path) -> str:
    """The source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_every_source_is_audited():
    assert {p.name for p in SOURCES} >= set(_build.SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_feature_offsets_are_64_bit(path):
    code = _code(path)
    products = re.findall(r"([\w\])>.]+)\s*\*\s*(?:f|f_v|f4)\b", code)
    wide = re.findall(r"static_cast<int64_t>\((?:[^()]|\([^()]*\))*\)\s*\*\s*"
                      r"(?:f|f_v|f4)\b", code)
    assert len(products) == len(wide), (path.name, products)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_slot_offsets_are_64_bit(path):
    code = _code(path)
    lhs = re.findall(r"([\w.\])]+)\s*\*\s*(?:b\.width|bk\.width|width|W)\b",
                     code)
    assert set(lhs) <= {"r", "p.r"}, (path.name, lhs)
    if "r" in lhs:
        decls = re.findall(r"\b(\w+)\s+r\s*(?:=|,|\))", code)
        assert decls and set(decls) == {"int64_t"}, (path.name, decls)
    if "p.r" in lhs:
        pos = _code(_build.CSRC / "ell_table.cuh")
        assert re.search(r"struct Pos \{[^}]*\bint64_t r;", pos)


def test_products_shape_offsets_need_64_bits():
    """The largest offsets the kernels form at the products shape: the ids,
    edge ids and slots fit int32, their products by F do not."""
    # a row of degree d takes the next width of 4..64 (at most 2d or 4
    # slots); a split row's pieces are full but for the last
    max_slots = 2 * NE + 4 * NV
    assert max_slots < 2**31 and NE < 2**31 and NV * F_MAX <= 2**31
    slot = np.array([max_slots - 1], np.int64)
    for f in (1, 16, 47, 100, 128, 256):
        off64 = slot * f + (f - 1)
        off32 = (slot.astype(np.int32) * np.int32(f)).astype(np.int64)
        assert off64[0] == (max_slots - 1) * f + f - 1
        if (max_slots - 1) * f >= 2**31:
            assert off32[0] != (max_slots - 1) * f     # 32 bits would wrap
    # a virtual row by its width: rows below 2^31 / 64 keep r * W in int32,
    # the kernels form it in int64 all the same
    rows = max_slots // 4
    assert rows * ELL_SPLIT < 2**63
