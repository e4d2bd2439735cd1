"""zlib container (RFC 1950): CMF/FLG header + DEFLATE + Adler-32 trailer.

Parity: reference crate src/zlib/ `ZlibEncoder`/`ZlibDecoder` ([HIGH] names,
SURVEY.md §2.1; behavior pinned by RFC 1950).
"""

from __future__ import annotations

import struct

from tpz import oracle
from tpz.codecs import deflate
from tpz.constants import ZLIB_CINFO_32K, ZLIB_CM_DEFLATE
from tpz.errors import DataError, UnexpectedEof


def header_bytes(level: int = 6) -> bytes:
    cmf = ZLIB_CM_DEFLATE | (ZLIB_CINFO_32K << 4)
    # FLEVEL advisory bits: 0 fastest .. 3 max.
    flevel = 0 if level <= 1 else (1 if level <= 5 else (2 if level == 6 else 3))
    flg = flevel << 6
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def compress(data: bytes, level: int = 6, backend: str = "auto") -> bytes:
    body = deflate.compress(data, level=level, backend=backend)
    adler = oracle.adler32(data) if oracle.available() else None
    if adler is None:
        from tpz.kernels.checksums import adler32 as _a32

        adler = _a32(data)
    return header_bytes(level) + body + struct.pack(">I", adler)


def compress_many(datas, level: int = 6,
                  backend: str = "auto") -> list[bytes]:
    """Batched zlib: device-batched DEFLATE bodies + per-buffer framing
    (the gzip compress_many shape)."""
    import struct as _struct

    bodies = deflate.compress_many(list(datas), level=level,
                                   backend=backend)
    out = []
    hdr = header_bytes(level)
    for d, body in zip(datas, bodies):
        adler = oracle.adler32(d) if oracle.available() else None
        if adler is None:
            from tpz.kernels.checksums import adler32 as _a32

            adler = _a32(d)
        out.append(hdr + body + _struct.pack(">I", adler))
    return out


def check_header(cmf: int, flg: int) -> None:
    """Validate the 2-byte CMF/FLG header (RFC 1950 §2.2)."""
    if (cmf * 256 + flg) % 31 != 0:
        raise DataError("zlib header FCHECK failed")
    if cmf & 0x0F != ZLIB_CM_DEFLATE:
        raise DataError(f"unsupported zlib CM {cmf & 0x0f}")
    if flg & 0x20:  # FDICT
        raise DataError("preset dictionaries not supported")


def decompress_prefix(data: bytes,
                      backend: str = "auto") -> tuple[bytes, int]:
    """Decode one zlib stream that may be followed by more data.
    Returns (plaintext, consumed_bytes incl. header and trailer).
    On the device path the DEFLATE body decodes device-parallel via the
    host segment indexer (no side-car needed; Adler-32 still checked)."""
    if len(data) < 6:
        raise UnexpectedEof("zlib stream too short")
    check_header(data[0], data[1])
    plain, consumed = deflate.decompress_prefix(data[2:], backend)
    trailer = data[2 + consumed : 2 + consumed + 4]
    if len(trailer) < 4:
        raise UnexpectedEof("missing adler32 trailer")
    (expect,) = struct.unpack(">I", trailer)
    actual = oracle.adler32(plain) if oracle.available() else None
    if actual is None:
        from tpz.kernels.checksums import adler32 as _a32

        actual = _a32(plain)
    if actual != expect:
        raise DataError(f"adler32 mismatch: {actual:#x} != {expect:#x}")
    return plain, 2 + consumed + 4


def decompress(data: bytes, backend: str = "auto") -> bytes:
    plain, consumed = decompress_prefix(data, backend)
    if consumed != len(data):  # RFC 1950 streams are exactly one member
        raise DataError(f"trailing garbage after zlib stream "
                        f"({len(data) - consumed} bytes)")
    return plain
