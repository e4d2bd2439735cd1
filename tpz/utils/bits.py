"""Host-side bit I/O, both bit orders.

Parity: the reference crate's src/bitio/ (direction-generic BitReader /
BitWriter / SmallBitVec, [MED] SURVEY.md §2.1). On device the equivalent is the
prefix-sum bitpack kernel (tpz/kernels/bitpack.py); this module is the
host/oracle-side counterpart used for framing, table headers, tests, and the
pure-Python reference codecs.

Direction convention (SURVEY.md §1):
  - LSB-first ("Right" in the crate): DEFLATE / zlib / gzip. Bits fill each
    byte from bit 0 upward; multi-bit values are written low-bit-first.
    Huffman codes are written MSB-of-code-first, which in LSB-first packing
    means the code must be bit-reversed before writing — we follow RFC 1951
    ("Huffman codes are packed starting with the most-significant bit").
  - MSB-first ("Left"): BZip2 / LZHUF. Bits fill each byte from bit 7 down.
"""

from __future__ import annotations


class BitWriterLSB:
    """LSB-first bit packer (DEFLATE family).

    write(value, n) emits the n low bits of value, low bit first.
    write_huff(code, n) emits a Huffman code of n bits, MSB of code first
    (i.e. reversed), per RFC 1951 §3.1.1.
    """

    __slots__ = ("_out", "_bitbuf", "_bitcnt")

    def __init__(self) -> None:
        self._out = bytearray()
        self._bitbuf = 0
        self._bitcnt = 0

    def write(self, value: int, nbits: int) -> None:
        self._bitbuf |= (value & ((1 << nbits) - 1)) << self._bitcnt
        self._bitcnt += nbits
        while self._bitcnt >= 8:
            self._out.append(self._bitbuf & 0xFF)
            self._bitbuf >>= 8
            self._bitcnt -= 8

    def write_huff(self, code: int, nbits: int) -> None:
        rev = 0
        for _ in range(nbits):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.write(rev, nbits)

    def align_byte(self) -> None:
        if self._bitcnt:
            self._out.append(self._bitbuf & 0xFF)
            self._bitbuf = 0
            self._bitcnt = 0

    def write_bytes(self, data: bytes) -> None:
        assert self._bitcnt == 0, "write_bytes requires byte alignment"
        self._out.extend(data)

    def getvalue(self) -> bytes:
        assert self._bitcnt == 0, "flush (align_byte) before getvalue"
        return bytes(self._out)

    @property
    def bit_length(self) -> int:
        return 8 * len(self._out) + self._bitcnt


class BitReaderLSB:
    """LSB-first bit reader (DEFLATE family)."""

    __slots__ = ("_data", "_pos", "_bitbuf", "_bitcnt")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0
        self._bitbuf = 0
        self._bitcnt = 0

    def _fill(self, need: int) -> None:
        while self._bitcnt < need:
            if self._pos >= len(self._data):
                from tpz.errors import UnexpectedEof

                raise UnexpectedEof("bit stream exhausted")
            self._bitbuf |= self._data[self._pos] << self._bitcnt
            self._pos += 1
            self._bitcnt += 8

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        self._fill(nbits)
        v = self._bitbuf & ((1 << nbits) - 1)
        self._bitbuf >>= nbits
        self._bitcnt -= nbits
        return v

    def align_byte(self) -> None:
        drop = self._bitcnt & 7
        self._bitbuf >>= drop
        self._bitcnt -= drop

    def read_bytes(self, n: int) -> bytes:
        assert self._bitcnt % 8 == 0
        out = bytearray()
        while self._bitcnt >= 8 and n > 0:
            out.append(self._bitbuf & 0xFF)
            self._bitbuf >>= 8
            self._bitcnt -= 8
            n -= 1
        if n > 0:
            if self._pos + n > len(self._data):
                from tpz.errors import UnexpectedEof

                raise UnexpectedEof("byte read past end")
            out.extend(self._data[self._pos : self._pos + n])
            self._pos += n
        return bytes(out)

    @property
    def bits_consumed(self) -> int:
        return 8 * self._pos - self._bitcnt


class BitWriterMSB:
    """MSB-first bit packer (BZip2 / LZHUF). Codes are written as-is,
    most-significant bit of the value first."""

    __slots__ = ("_out", "_bitbuf", "_bitcnt")

    def __init__(self) -> None:
        self._out = bytearray()
        self._bitbuf = 0
        self._bitcnt = 0

    def write(self, value: int, nbits: int) -> None:
        self._bitbuf = (self._bitbuf << nbits) | (value & ((1 << nbits) - 1))
        self._bitcnt += nbits
        while self._bitcnt >= 8:
            self._bitcnt -= 8
            self._out.append((self._bitbuf >> self._bitcnt) & 0xFF)
        self._bitbuf &= (1 << self._bitcnt) - 1

    # Huffman codes in MSB-first streams are written directly.
    write_huff = write

    def align_byte(self) -> None:
        if self._bitcnt:
            self._out.append((self._bitbuf << (8 - self._bitcnt)) & 0xFF)
            self._bitbuf = 0
            self._bitcnt = 0

    def getvalue(self) -> bytes:
        assert self._bitcnt == 0, "flush (align_byte) before getvalue"
        return bytes(self._out)

    @property
    def bit_length(self) -> int:
        return 8 * len(self._out) + self._bitcnt


class BitReaderMSB:
    """MSB-first bit reader (BZip2 / LZHUF)."""

    __slots__ = ("_data", "_pos", "_bitbuf", "_bitcnt")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0
        self._bitbuf = 0
        self._bitcnt = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        while self._bitcnt < nbits:
            if self._pos >= len(self._data):
                from tpz.errors import UnexpectedEof

                raise UnexpectedEof("bit stream exhausted")
            self._bitbuf = (self._bitbuf << 8) | self._data[self._pos]
            self._pos += 1
            self._bitcnt += 8
        self._bitcnt -= nbits
        v = (self._bitbuf >> self._bitcnt) & ((1 << nbits) - 1)
        self._bitbuf &= (1 << self._bitcnt) - 1
        return v

    def peek(self, nbits: int) -> int:
        """Peek up to nbits (zero-padded past end-of-stream)."""
        while self._bitcnt < nbits and self._pos < len(self._data):
            self._bitbuf = (self._bitbuf << 8) | self._data[self._pos]
            self._pos += 1
            self._bitcnt += 8
        if self._bitcnt >= nbits:
            return (self._bitbuf >> (self._bitcnt - nbits)) & ((1 << nbits) - 1)
        return (self._bitbuf << (nbits - self._bitcnt)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        if nbits > self._bitcnt:
            raise ValueError("skip past buffered bits")
        self._bitcnt -= nbits
        self._bitbuf &= (1 << self._bitcnt) - 1

    @property
    def bits_consumed(self) -> int:
        return 8 * self._pos - self._bitcnt
