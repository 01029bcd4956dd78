"""Bit-level Elias gamma / zeta_k codecs.

The port's own copy of ``graphaibench_tpu/compress/unary.py`` (same names,
same bits; ``tests/test_torch_compress.py`` holds them equal).

Exact bit format of the reference's unary_encoder
(src/structure/unary_encoder.cc / include/unary_encoder.hh):

  gamma(x): let y = x+1, len = floor(log2(y)).
            Write '1' in (len+1) bits (i.e. len zeros then a one),
            then the low ``len`` bits of y.
  zeta_k(x): let y = x+1, len = floor(log2(y)), h = len // k.
             Write '1' in (h+1) bits, then y in (h+1)*k bits.
             zeta_1 == gamma.
  int_2_nat(x): x >= 0 -> 2x, x < 0 -> -(2x+1)  (signed first-delta).

Bits are MSB-first within the stream; bytes are packed MSB-first
(Compressor::bits_to_bytes, compressor.cc:55-84).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0  # bits in cur

    def write(self, value: int, length: int):
        """Append the low ``length`` bits of value, MSB first."""
        for i in range(length - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.buf.append(self.cur)
                self.cur = 0
                self.nbits = 0

    @property
    def bit_length(self) -> int:
        return len(self.buf) * 8 + self.nbits

    def align(self, unit_bits: int):
        """Zero-pad to a multiple of unit_bits."""
        pad = (-self.bit_length) % unit_bits
        if pad:
            self.write(0, pad)

    def getvalue(self) -> bytes:
        out = bytearray(self.buf)
        if self.nbits:
            out.append((self.cur << (8 - self.nbits)) & 0xFF)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes, bit_offset: int = 0):
        self.data = data
        self.pos = bit_offset

    def read(self, length: int) -> int:
        v = 0
        for _ in range(length):
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v

    def read_unary_then(self) -> int:
        """Count bits until (and including) the first 1: returns the
        number of bits consumed (== len+1 for gamma)."""
        n = 0
        while True:
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            self.pos += 1
            n += 1
            if bit:
                return n


def int_2_nat(x: int) -> int:
    return x << 1 if x >= 0 else -((x << 1) + 1)


def nat_2_int(n: int) -> int:
    return n >> 1 if (n & 1) == 0 else -((n + 1) >> 1)


def gamma_len(x: int) -> int:
    y = x + 1
    return 2 * (y.bit_length() - 1) + 1


def zeta_len(x: int, k: int) -> int:
    if k == 1:
        return gamma_len(x)
    y = x + 1
    h = (y.bit_length() - 1) // k
    return (h + 1) * (k + 1)


def write_gamma(w: BitWriter, x: int):
    y = x + 1
    length = y.bit_length() - 1
    w.write(1, length + 1)
    w.write(y, length)


def write_zeta(w: BitWriter, x: int, k: int):
    if k == 1:
        return write_gamma(w, x)
    y = x + 1
    length = y.bit_length() - 1
    h = length // k
    w.write(1, h + 1)
    w.write(y, (h + 1) * k)


def read_gamma(r: BitReader) -> int:
    n = r.read_unary_then()  # len+1 bits consumed
    length = n - 1
    y = (1 << length) | r.read(length)
    return y - 1


def read_zeta(r: BitReader, k: int) -> int:
    if k == 1:
        return read_gamma(r)
    n = r.read_unary_then()
    h = n - 1
    y = r.read((h + 1) * k)
    return y - 1
