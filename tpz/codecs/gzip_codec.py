"""gzip container (RFC 1952): header + DEFLATE + CRC-32/ISIZE trailer.

Parity: reference crate src/gzip/ `GZipEncoder`/`GZipDecoder` ([HIGH] names,
SURVEY.md §2.1; behavior pinned by RFC 1952). Decode handles the optional
FEXTRA/FNAME/FCOMMENT/FHCRC fields and multi-member streams.
"""

from __future__ import annotations

import struct

from tpz import device, oracle
from tpz.codecs import deflate
from tpz.constants import GZIP_CM_DEFLATE, GZIP_MAGIC, GZIP_OS_UNIX
from tpz.errors import DataError, UnexpectedEof

_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 1, 2, 4, 8, 16


def _crc32(data: bytes) -> int:
    if oracle.available():
        return oracle.crc32_reflected(data) ^ 0xFFFFFFFF
    from tpz.kernels.checksums import crc32

    return crc32(data, "reflected")


def header_bytes(level: int = 6, mtime: int = 0, extra: bytes = b"") -> bytes:
    xfl = 2 if level >= 7 else (4 if level <= 1 else 0)
    flg = _FEXTRA if extra else 0
    hdr = GZIP_MAGIC + bytes([GZIP_CM_DEFLATE, flg]) + struct.pack(
        "<I", mtime) + bytes([xfl, GZIP_OS_UNIX])
    if extra:
        hdr += struct.pack("<H", len(extra)) + extra
    return hdr


# 'TZ' FEXTRA subfield: the encoder's DEFLATE-block index (SURVEY.md §7.4
# encoder-assisted decode side-car). RFC 1952 §2.3.1.1: unknown subfields
# must be ignored, so gunzip/zlib interop is unaffected; tpz's decoder uses
# it to decode blocks device-parallel. Layout (all LE):
#   u8 version=1, u8 reserved, u16 nblocks,
#   nblocks x (u32 end_bit_of_block, u32 block_out_len)
_TZ_ID = b"TZ"
_TZ_MAX_BLOCKS = (65535 - 8) // 8


def _tz_extra(block_bits, block_lens) -> bytes:
    import numpy as np

    nb = len(block_bits)
    payload = struct.pack("<BBH", 1, 0, nb) + np.stack(
        [np.asarray(block_bits, np.uint32),
         np.asarray(block_lens, np.uint32)], axis=1).tobytes()
    return _TZ_ID + struct.pack("<H", len(payload)) + payload


def parse_tz_extra(extra: bytes):
    """Returns (end_bits, out_lens) numpy arrays or None."""
    import numpy as np

    off = 0
    while off + 4 <= len(extra):
        sid = extra[off:off + 2]
        (slen,) = struct.unpack_from("<H", extra, off + 2)
        body = extra[off + 4 : off + 4 + slen]
        off += 4 + slen
        if sid != _TZ_ID or len(body) < 4:
            continue
        ver, _, nb = struct.unpack_from("<BBH", body, 0)
        if ver != 1 or len(body) < 4 + 8 * nb:
            continue
        arr = np.frombuffer(body, np.uint32, count=2 * nb, offset=4)
        arr = arr.reshape(nb, 2)
        return arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64)
    return None


def compress(data: bytes, level: int = 6, backend: str = "auto",
             mtime: int = 0, index: bool = True) -> bytes:
    body, block_bits, block_lens = deflate.compress_indexed(
        data, level=level, backend=backend)
    extra = b""
    if (index and block_bits is not None
            and len(block_bits) <= _TZ_MAX_BLOCKS):
        extra = _tz_extra(block_bits, block_lens)
    trailer = struct.pack("<II", _crc32(data), len(data) & 0xFFFFFFFF)
    return header_bytes(level, mtime, extra) + body + trailer


def _parse_header(data: bytes, off: int) -> int:
    pos, _ = parse_header_extra(data, off)
    return pos


def parse_header_extra(data: bytes, off: int) -> tuple[int, bytes]:
    """Parse a member header; returns (body offset, FEXTRA bytes)."""
    if len(data) - off < 10:
        raise UnexpectedEof("gzip header truncated")
    if data[off : off + 2] != GZIP_MAGIC:
        raise DataError("bad gzip magic")
    if data[off + 2] != GZIP_CM_DEFLATE:
        raise DataError(f"unsupported gzip CM {data[off + 2]}")
    flg = data[off + 3]
    extra = b""
    pos = off + 10
    if flg & _FEXTRA:
        if len(data) - pos < 2:
            raise UnexpectedEof("FEXTRA truncated")
        (xlen,) = struct.unpack_from("<H", data, pos)
        extra = data[pos + 2 : pos + 2 + xlen]
        pos += 2 + xlen
    if flg & _FNAME:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise UnexpectedEof("FNAME unterminated")
        pos = end + 1
    if flg & _FCOMMENT:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise UnexpectedEof("FCOMMENT unterminated")
        pos = end + 1
    if flg & _FHCRC:
        if len(data) - pos < 2:
            raise UnexpectedEof("FHCRC truncated")
        (hcrc,) = struct.unpack_from("<H", data, pos)
        # header CRC16 = low 16 bits of CRC-32 over the header bytes
        if hcrc != _crc32(data[off:pos]) & 0xFFFF:
            raise DataError("gzip header CRC mismatch")
        pos += 2
    if pos > len(data):
        raise UnexpectedEof("gzip header overruns input")
    return pos, extra


def decompress_member_prefix(data: bytes, off: int = 0,
                             backend: str = "auto") -> tuple[bytes, int]:
    """Decode one gzip member starting at `off`; returns (plaintext,
    offset just past the member's trailer). Used by the streaming decode
    facade (member granularity).

    On the device path (tpz.device.use_device), a member carrying the
    encoder's 'TZ' block index decodes block-parallel from that index,
    and any other member through the host segment indexer
    (tpz/kernels/inflate_pipeline.py); the CRC32/ISIZE trailer check
    below guards the device path too."""
    on_device = device.use_device(backend)
    pos, extra = parse_header_extra(data, off)
    plain = None
    consumed = None
    idx = parse_tz_extra(extra) if extra else None
    if idx is not None and on_device:
        from tpz.kernels import inflate_pipeline

        # The side-car is untrusted input (ADVICE r2): a crafted/foreign
        # index must not crash or over-allocate — validate shape bounds
        # and fall back to the host path on anything suspicious.
        end_bits, out_lens = idx
        body_cap = len(data) - pos - 8  # member body ends before trailer
        ok = (
            len(end_bits) >= 1
            and bool((end_bits[:-1] < end_bits[1:]).all())
            and int(end_bits[0]) > 0
            and (int(end_bits[-1]) + 7) // 8 <= body_cap
            and bool((out_lens[:-1] == inflate_pipeline.BLOCK).all())
            and 0 <= int(out_lens[-1]) <= inflate_pipeline.BLOCK
            # Oversized members dispatch alone under the WIDE
            # resolution (decompress_many_indexed routes them).
            and len(end_bits) * inflate_pipeline.BLOCK
            <= inflate_pipeline.MAX_DECODE_SPAN_WIDE
        )
        if ok:
            nbytes = (int(end_bits[-1]) + 7) // 8
            plain = inflate_pipeline.decompress_indexed(
                data[pos:pos + nbytes], end_bits, out_lens)
            consumed = nbytes
    if plain is None and on_device:
        # Foreign member (no TZ side-car): the host segment indexer
        # (SURVEY.md §7.4 route 2) makes ANY member device-decodable.
        from tpz.kernels import inflate_pipeline

        idx = inflate_pipeline.index_stream(data[pos:])
        if idx is not None:
            plain = inflate_pipeline.decompress_segmented(data[pos:], idx)
            consumed = idx["consumed"]
    if plain is None:
        plain, consumed = deflate.decompress_prefix(data[pos:], "oracle")
    tpos = pos + consumed
    if len(data) - tpos < 8:
        raise UnexpectedEof("gzip trailer truncated")
    crc, isize = struct.unpack_from("<II", data, tpos)
    if crc != _crc32(plain):
        raise DataError("gzip CRC mismatch")
    if isize != len(plain) & 0xFFFFFFFF:
        raise DataError("gzip ISIZE mismatch")
    return plain, tpos + 8


def decompress(data: bytes, backend: str = "auto") -> bytes:
    if device.use_device(backend):
        out = _decompress_members_batched(data)
        if out is not None:
            return out
    out = bytearray()
    off = 0
    while off < len(data):
        plain, off = decompress_member_prefix(data, off, backend)
        out += plain
    if not out and len(data) == 0:
        raise UnexpectedEof("empty gzip input")
    return bytes(out)


def decompress_many(datas, backend: str = "auto") -> list[bytes]:
    """Batched gzip decode (round 3 serving shape): on the device path
    every TZ-indexed member across EVERY buffer decodes in one fused
    device dispatch; other buffers decode one by one."""
    datas = list(datas)
    results = [None] * len(datas)
    if device.use_device(backend):
        from tpz.kernels import inflate_pipeline

        scans = [_scan_members_indexed(d) for d in datas]
        items = []
        for s in scans:
            if s is not None:
                items.extend(s[0])
        if items:
            plains = inflate_pipeline.decompress_many_indexed(items)
            pos = 0
            for i, s in enumerate(scans):
                if s is None:
                    continue
                its, metas = s
                out = bytearray()
                for plain, (crc, isize) in zip(
                        plains[pos:pos + len(its)], metas):
                    if plain is None:  # declined: decode member by member
                        out = None
                        break
                    if (crc != _crc32(plain)
                            or isize != len(plain) & 0xFFFFFFFF):
                        raise DataError("gzip CRC mismatch")
                    out += plain
                pos += len(its)
                results[i] = None if out is None else bytes(out)
    for i, d in enumerate(datas):
        if results[i] is None:
            results[i] = decompress(d, backend=backend)
    return results


def _scan_members_indexed(data: bytes):
    """Member scan without decoding: returns (items, metas) for
    decompress_many_indexed when EVERY member carries a valid TZ index,
    else None."""
    import struct as _s

    from tpz.kernels import inflate_pipeline

    items = []
    metas = []  # (plain crc, isize)
    off = 0
    try:
        while off < len(data):
            pos, extra = parse_header_extra(data, off)
            idx = parse_tz_extra(extra) if extra else None
            if idx is None:
                return None
            end_bits, out_lens = idx
            body_cap = len(data) - pos - 8
            if not (len(end_bits) >= 1
                    and bool((end_bits[:-1] < end_bits[1:]).all())
                    and int(end_bits[0]) > 0
                    and (int(end_bits[-1]) + 7) // 8 <= body_cap
                    and bool((out_lens[:-1]
                              == inflate_pipeline.BLOCK).all())
                    and 0 <= int(out_lens[-1]) <= inflate_pipeline.BLOCK
                    and len(end_bits) * inflate_pipeline.BLOCK
                    <= inflate_pipeline.MAX_DECODE_SPAN_WIDE):
                return None
            nbytes = (int(end_bits[-1]) + 7) // 8
            items.append((data[pos:pos + nbytes], end_bits, out_lens))
            tpos = pos + nbytes
            if len(data) - tpos < 8:
                raise UnexpectedEof("gzip trailer truncated")
            metas.append(_s.unpack_from("<II", data, tpos))
            off = tpos + 8
    except (DataError, UnexpectedEof):
        return None
    if not items:
        return None
    return items, metas


def _decompress_members_batched(data: bytes) -> bytes | None:
    """One buffer's members in ONE fused device dispatch when every
    member carries the TZ index (tpz's own multi-member output, e.g.
    the sharded encoder's); None -> caller walks members individually."""
    from tpz.kernels import inflate_pipeline

    s = _scan_members_indexed(data)
    if s is None:
        return None
    items, metas = s
    plains = inflate_pipeline.decompress_many_indexed(items)
    out = bytearray()
    for plain, (crc, isize) in zip(plains, metas):
        if plain is None:  # declined: the caller walks the members
            return None
        if crc != _crc32(plain) or isize != len(plain) & 0xFFFFFFFF:
            raise DataError("gzip CRC mismatch")
        out += plain
    return bytes(out)


def compress_many(datas, level: int = 6, backend: str = "auto",
                  mtime: int = 0) -> list[bytes]:
    """Batched gzip: device-batched DEFLATE bodies + per-buffer framing."""
    bodies = deflate.compress_many(datas, level=level, backend=backend)
    out = []
    header = header_bytes(level, mtime)
    for d, body in zip(datas, bodies):
        trailer = struct.pack("<II", _crc32(d), len(d) & 0xFFFFFFFF)
        out.append(header + body + trailer)
    return out
