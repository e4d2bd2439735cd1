"""Top-level codec API.

Parity: the reference crate's prelude (`EncodeExt::encode` / `DecodeExt::
decode` iterator adapters, [HIGH] SURVEY.md §2.1 "Encode/Decode traits").
The device pipelines are block-oriented, so the primary surface is
whole-buffer `compress`/`decompress`; `CodecStream` provides the streaming/
Action-driven shape of the crate's API at the host boundary.
"""

from __future__ import annotations

from typing import Callable

from tpz.action import Action
from tpz.errors import DataError

_FORMATS: dict[str, tuple[Callable, Callable]] = {}


def register_format(name: str, compress_fn: Callable, decompress_fn: Callable):
    _FORMATS[name] = (compress_fn, decompress_fn)


def _load():
    if _FORMATS:
        return
    from tpz.codecs import deflate, gzip_codec, zlib_codec

    register_format("deflate", deflate.compress, deflate.decompress)
    register_format("zlib", zlib_codec.compress, zlib_codec.decompress)
    register_format("gzip", gzip_codec.compress, gzip_codec.decompress)
    try:
        from tpz.codecs import lzss as _lzss

        register_format("lzss", _lzss.compress, _lzss.decompress)
    except ImportError:
        pass
    try:
        from tpz.codecs import lzhuf as _lzhuf

        for m in ("lh4", "lh5", "lh6", "lh7"):
            register_format(
                m,
                (lambda d, level=6, backend="auto", _m=m:
                 _lzhuf.compress(d, method=_m, backend=backend)),
                (lambda d, backend="auto", _m=m:
                 _lzhuf.decompress(d, method=_m, backend=backend)),
            )
    except ImportError:
        pass
    try:
        from tpz.codecs import bzip2 as _bz2

        register_format("bzip2", _bz2.compress, _bz2.decompress)
    except ImportError:
        pass


def formats() -> list[str]:
    _load()
    return sorted(_FORMATS)


def compress(data: bytes, format: str = "gzip", level: int = 6,
             backend: str = "auto") -> bytes:
    _load()
    if format not in _FORMATS:
        raise ValueError(f"unknown format {format!r}; have {formats()}")
    return _FORMATS[format][0](data, level=level, backend=backend)


def decompress(data: bytes, format: str = "gzip",
               backend: str = "auto") -> bytes:
    _load()
    if format not in _FORMATS:
        raise ValueError(f"unknown format {format!r}; have {formats()}")
    fn = _FORMATS[format][1]
    if format in ("deflate", "zlib", "gzip", "bzip2",
                  "lh4", "lh5", "lh6", "lh7"):
        return fn(data, backend=backend)
    return fn(data)


def compress_many(datas, format: str = "gzip", level: int = 6,
                  backend: str = "auto") -> list[bytes]:
    """Batch compression: one device invocation covers every buffer for
    DEFLATE-family formats (the production serving shape); other formats
    fall back to a per-buffer loop."""
    _load()
    if format in ("deflate", "gzip", "zlib"):
        from tpz.codecs import deflate as _d, gzip_codec as _g
        from tpz.codecs import zlib_codec as _z

        fn = {"gzip": _g.compress_many, "deflate": _d.compress_many,
              "zlib": _z.compress_many}[format]
        return fn(list(datas), level=level, backend=backend)
    if format == "bzip2":
        from tpz.codecs import bzip2 as _bz

        return _bz.compress_many(list(datas), level=level, backend=backend)
    if format in ("lh4", "lh5", "lh6", "lh7"):
        from tpz.codecs import lzhuf as _lz

        return _lz.compress_many(list(datas), method=format, level=level,
                                 backend=backend)
    return [compress(d, format, level=level, backend=backend) for d in datas]


def decompress_many(datas, format: str = "gzip",
                    backend: str = "auto") -> list[bytes]:
    """Batch decode (the serving shape's inverse): gzip batches every
    TZ-indexed member across buffers into one device dispatch; other
    formats decode per buffer."""
    _load()
    if format == "gzip":
        from tpz.codecs import gzip_codec as _g

        return _g.decompress_many(list(datas), backend=backend)
    if format == "bzip2":
        from tpz.codecs import bzip2 as _bz

        return _bz.decompress_many(list(datas), backend=backend)
    if format in ("lh4", "lh5", "lh6", "lh7"):
        from tpz.codecs import lzhuf as _lz

        return _lz.decompress_many(list(datas), method=format,
                                   backend=backend)
    return [decompress(d, format, backend=backend) for d in datas]


# Formats whose streams may be concatenated and decoded as one logical
# stream by our decoder (gzip multi-member per RFC 1952 §2.2; bzip2
# multi-stream like the `bzip2` tool).
_CONCAT_OK = frozenset({"gzip", "bzip2"})
# DEFLATE-family formats with true in-stream Flush (Z_SYNC_FLUSH-style
# empty stored block; one header, one trailer, one stream).
_DEFLATE_FAMILY = frozenset({"deflate", "zlib", "gzip"})


class CodecStream:
    """Streaming encode facade with the crate's Action semantics
    (reference src/action.rs Action::{Run, Flush, Finish} [HIGH]
    SURVEY.md §2.1).

    write(b) buffers input (Action::Run); flush() forces a byte-aligned
    segment boundary (Action::Flush) and returns the compressed bytes for
    the buffered data; finish() terminates the stream (Action::Finish).

    For the DEFLATE family (deflate/zlib/gzip) flush is a true in-stream
    flush: each segment's blocks carry BFINAL=0 and end with a
    Z_SYNC_FLUSH empty stored block, the container header is emitted
    exactly once and the checksum trailer covers ALL plaintext — the
    concatenated output is a single valid stream. bzip2 flush emits an
    independent stream per segment (valid multi-stream concatenation).
    Formats whose containers cannot be concatenated (lzss, lh4-lh7)
    raise DataError on flush; Run/Finish work for every format.
    """

    def __init__(self, format: str = "gzip", level: int = 6,
                 backend: str = "auto") -> None:
        _load()
        if format not in _FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self._format = format
        self._level = level
        self._backend = backend
        self._buf = bytearray()
        self._finished = False
        self._header_emitted = False
        self._total = 0
        self._crc_state = 0xFFFFFFFF  # gzip running CRC-32 (pre-xor state)
        self._adler_state = 1  # zlib running Adler-32

    def write(self, data: bytes) -> None:
        if self._finished:
            raise DataError("stream already finished")
        self._buf += data

    def _deflate_header(self) -> bytes:
        if self._header_emitted:
            return b""
        self._header_emitted = True
        if self._format == "gzip":
            from tpz.codecs import gzip_codec

            return gzip_codec.header_bytes(self._level)
        if self._format == "zlib":
            from tpz.codecs import zlib_codec

            return zlib_codec.header_bytes(self._level)
        return b""

    def _account(self, data: bytes) -> None:
        from tpz import oracle

        self._total += len(data)
        if self._format == "gzip":
            self._crc_state = oracle.crc32_reflected(data, self._crc_state)
        elif self._format == "zlib":
            self._adler_state = oracle.adler32(data, self._adler_state)

    def flush(self) -> bytes:
        if self._finished:
            raise DataError("stream already finished")
        if self._format in _DEFLATE_FAMILY:
            from tpz.codecs import deflate as _deflate

            if not self._buf:
                return b""
            data = bytes(self._buf)
            self._buf.clear()
            self._account(data)
            return self._deflate_header() + _deflate.compress_flush(
                data, self._level)
        if self._format in _CONCAT_OK:
            if not self._buf:
                return b""
            data = bytes(self._buf)
            self._buf.clear()
            return compress(data, self._format, self._level, self._backend)
        raise DataError(
            f"format {self._format!r} has no concatenable stream form; "
            f"Action::Flush is not supported (use Run/Finish)")

    def finish(self) -> bytes:
        import struct

        if self._finished:
            raise DataError("stream already finished")
        self._finished = True
        data = bytes(self._buf)
        self._buf.clear()
        if self._format in _DEFLATE_FAMILY:
            from tpz.codecs import deflate as _deflate

            self._account(data)
            if not self._header_emitted:
                # No flush ever happened: whole-buffer fast path (device-
                # batched for large inputs) — bytes identical to compress().
                return compress(data, self._format, self._level,
                                self._backend)
            # Final segment continues the flushed stream: its last block
            # carries BFINAL, then the container trailer over ALL data.
            body = _deflate.compress(data, self._level,
                                     backend=self._backend)
            if self._format == "gzip":
                trailer = struct.pack(
                    "<II", self._crc_state ^ 0xFFFFFFFF,
                    self._total & 0xFFFFFFFF)
            elif self._format == "zlib":
                trailer = struct.pack(">I", self._adler_state)
            else:
                trailer = b""
            return body + trailer
        return compress(data, self._format, self._level, self._backend)

    def drive(self, data: bytes, action: Action) -> bytes:
        """Crate-style single entry point: feed bytes + an Action."""
        self.write(data)
        if action is Action.RUN:
            return b""
        if action is Action.FLUSH:
            return self.flush()
        return self.finish()


class _MemberInflate:
    """One resumable raw-DEFLATE stream (cpp InflateStream via the oracle).
    Tracks fed-vs-consumed so the bytes past the stream end (container
    trailer / next member) are recoverable from the finishing chunk."""

    def __init__(self) -> None:
        from tpz import oracle

        self._s = oracle.InflateStream()
        self._fed = 0
        self.done = False
        self.extra = b""  # bytes past the stream end (from the last chunk)

    def feed(self, data: bytes) -> bytes:
        out = self._s.feed(data)
        self._fed += len(data)
        if self._s.finished:
            self.done = True
            overshoot = self._fed - self._s.consumed
            # The decoder never consumes past the final EOB, so overshoot
            # bytes all come from the chunk that finished the stream.
            self.extra = data[len(data) - overshoot:] if overshoot else b""
            self._s.close()
        return out


class DecodeStream:
    """Streaming decode facade (parity: the crate's DecodeExt iterator
    adapters, [HIGH] SURVEY.md §2.1 — decode-side Action symmetry).

    write(b) feeds compressed bytes and returns any plaintext that became
    decodable (member granularity for gzip, stream granularity
    otherwise); finish() returns the remaining plaintext and raises
    UnexpectedEof if the stream is incomplete, DataError on trailing
    garbage after a completed single-stream format.

    The DEFLATE family decodes incrementally (resumable cpp InflateStream
    + running checksums), bzip2 decodes block-granularly (magic-
    delimited blocks decode as they complete, round 4), and lh4-lh7
    stream through the resumable cpp LzhufStream (round 5): many small
    writes cost O(total bytes), not O(writes x stream). Only raw lzss
    retries a full parse per write (no internal delimiters; the format
    is a bare token stream used for lh0/testing).
    """

    def __init__(self, format: str = "gzip") -> None:
        _load()
        if format not in _FORMATS:
            raise ValueError(f"unknown format {format!r}")
        self._format = format
        self._buf = bytearray()  # header/trailer bytes (incremental mode)
        self._finished = False
        if format in _DEFLATE_FAMILY:
            self._state = "body" if format == "deflate" else "header"
            self._inf: _MemberInflate | None = None
            self._plain = bytearray()  # current member, pending emit
            self._crc = 0xFFFFFFFF
            self._adler = 1
            self._any_input = False
        elif format == "bzip2":
            from tpz.codecs import bzip2 as _bz

            self._state = "bz2"
            self._inc = _bz.IncrementalDecoder()
        elif format in ("lh4", "lh5", "lh6", "lh7"):
            # Incremental lh4-lh7 (VERDICT r4 item 9): container header
            # buffered here, body through the resumable cpp LzhufStream
            # — O(total) across any write pattern.
            self._state = "lzhuf-header"
            self._lzh = None
        else:
            self._state = "buffered"

    # ------------------------------------------------- DEFLATE-family pump
    def _pump(self, data: bytes) -> bytes:
        from tpz import oracle
        from tpz.errors import UnexpectedEof

        out = bytearray()
        buf = data
        while True:
            if self._state == "header":
                self._buf += buf
                buf = b""
                if self._format == "zlib":
                    if len(self._buf) < 2:
                        break
                    from tpz.codecs import zlib_codec

                    zlib_codec.check_header(self._buf[0], self._buf[1])
                    buf = bytes(self._buf[2:])
                else:  # gzip
                    from tpz.codecs import gzip_codec

                    try:
                        pos, _ = gzip_codec.parse_header_extra(
                            bytes(self._buf), 0)
                    except UnexpectedEof:
                        break
                    buf = bytes(self._buf[pos:])
                self._buf.clear()
                self._inf = _MemberInflate()
                self._state = "body"
            elif self._state == "body":
                if self._inf is None:
                    self._inf = _MemberInflate()
                if not buf and not self._inf.done:
                    break
                chunk = self._inf.feed(buf)
                buf = b""
                if chunk:
                    self._plain += chunk
                    if self._format == "gzip":
                        self._crc = oracle.crc32_reflected(chunk, self._crc)
                    elif self._format == "zlib":
                        self._adler = oracle.adler32(chunk, self._adler)
                if not self._inf.done:
                    break
                buf = self._inf.extra
                self._inf = None
                self._state = "trailer"
            elif self._state == "trailer":
                import struct

                self._buf += buf
                buf = b""
                if self._format == "deflate":
                    out += self._plain
                    self._plain.clear()
                    self._state = "done"
                    continue
                need = 8 if self._format == "gzip" else 4
                if len(self._buf) < need:
                    break
                if self._format == "gzip":
                    crc, isize = struct.unpack_from("<II", self._buf, 0)
                    if crc != self._crc ^ 0xFFFFFFFF:
                        raise DataError("gzip CRC mismatch")
                    if isize != len(self._plain) & 0xFFFFFFFF:
                        raise DataError("gzip ISIZE mismatch")
                    self._crc = 0xFFFFFFFF
                else:
                    (expect,) = struct.unpack_from(">I", self._buf, 0)
                    if expect != self._adler:
                        raise DataError(
                            f"adler32 mismatch: {self._adler:#x} != "
                            f"{expect:#x}")
                out += self._plain
                self._plain.clear()
                buf = bytes(self._buf[need:])
                self._buf.clear()
                # gzip: further members may follow; zlib: exactly one.
                self._state = "header" if self._format == "gzip" else "done"
                if self._state == "header" and not buf:
                    break
            elif self._state == "done":
                self._buf += buf
                break
        return bytes(out)

    def _pump_final(self) -> None:
        from tpz.errors import UnexpectedEof

        if self._state == "done":
            if self._buf:
                raise DataError(
                    f"trailing garbage after {self._format} stream")
            return
        if self._state == "header":
            if not self._buf:
                return  # clean end at a member boundary
            if self._format == "gzip":
                from tpz.codecs import gzip_codec

                # Raises UnexpectedEof (truncated) or DataError (garbage).
                gzip_codec.parse_header_extra(bytes(self._buf), 0)
            raise UnexpectedEof(f"{self._format} header truncated")
        if self._state == "body" and self._format == "deflate" \
                and not self._any_input:
            return  # nothing ever written
        raise UnexpectedEof(f"{self._format} stream truncated")

    # ------------------------------------------------------------- surface
    def _drain_buffered(self, final: bool) -> bytes:
        from tpz.errors import UnexpectedEof

        # Whole-buffer formats (bzip2 multi-stream, lzss, lh4-lh7): emit
        # when the accumulated input parses completely.
        if not self._buf:
            return b""
        try:
            plain = decompress(bytes(self._buf), self._format)
        except UnexpectedEof:
            if final:
                raise
            return b""
        self._buf.clear()
        return plain

    def _lzhuf_write(self, data: bytes) -> bytes:
        import struct

        from tpz import oracle
        from tpz.constants import LZHUF_METHODS

        if self._state == "lzhuf-header":
            self._buf += data
            if len(self._buf) < 15:
                return b""
            from tpz.codecs.lzhuf import _MAGIC

            if bytes(self._buf[:4]) != _MAGIC:
                raise DataError("bad lzhuf container magic")
            m = bytes(self._buf[4:7]).decode()
            if m != self._format:
                raise DataError(f"container method {m} != {self._format}")
            (size,) = struct.unpack_from("<Q", self._buf, 7)
            self._lzh = oracle.LzhufStream(LZHUF_METHODS[m][0], size)
            body = bytes(self._buf[15:])
            self._buf.clear()
            self._state = "lzhuf-body"
            return self._lzh.feed(body)
        return self._lzh.feed(data)

    def write(self, data: bytes) -> bytes:
        if self._finished:
            raise DataError("decode stream already finished")
        if self._state == "bz2":
            return self._inc.write(data)
        if self._state in ("lzhuf-header", "lzhuf-body"):
            return self._lzhuf_write(data)
        if self._state == "buffered":
            self._buf += data
            return self._drain_buffered(final=False)
        if data:
            self._any_input = True
        return self._pump(data)

    def finish(self) -> bytes:
        if self._finished:
            raise DataError("decode stream already finished")
        self._finished = True
        if self._state == "bz2":
            return self._inc.finish()
        if self._state in ("lzhuf-header", "lzhuf-body"):
            from tpz.errors import UnexpectedEof

            out = self._lzhuf_write(b"")
            if self._state == "lzhuf-header" and not self._buf \
                    and self._lzh is None:
                raise UnexpectedEof("empty lzhuf input")
            if self._lzh is None or not self._lzh.finished:
                raise UnexpectedEof(f"{self._format} stream truncated")
            self._lzh.close()
            return out
        if self._state == "buffered":
            return self._drain_buffered(final=True)
        out = self._pump(b"")
        self._pump_final()
        return out
