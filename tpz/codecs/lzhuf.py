"""LZHUF codec — LHA static-Huffman methods lh4..lh7.

Parity: reference crate src/lzhuf/ `LzhufEncoder::new(&LzhufMethod)` /
`LzhufDecoder` ([HIGH] names, SURVEY.md §2.1; Q4 resolved to the static
lh4-lh7 scheme). `raw_compress`/`raw_decompress` mirror the crate's raw
stream (no size header — LHA archives carry the original size in the
archive header). `compress`/`decompress` add a minimal container
(magic + method + u64 size) so the generic tpz.api surface works.
"""

from __future__ import annotations

import struct

from tpz import device, oracle
from tpz.constants import LZHUF_METHODS
from tpz.errors import DataError, UnexpectedEof

_MAGIC = b"TPZL"


def _dict_bits(method: str) -> int:
    if method not in LZHUF_METHODS:
        raise ValueError(f"unknown lzhuf method {method!r}; have "
                         f"{sorted(LZHUF_METHODS)}")
    return LZHUF_METHODS[method][0]


def raw_compress(data: bytes, method: str = "lh5", max_chain: int = 16,
                 backend: str = "auto") -> bytes:
    bits = _dict_bits(method)
    if device.use_device(backend):
        from tpz.kernels import lzhuf_pipeline

        return lzhuf_pipeline.compress(data, method, max_chain)
    return oracle.lzhuf_encode(data, bits, max_chain)


def raw_decompress(data: bytes, orig_size: int, method: str = "lh5",
                   backend: str = "auto") -> bytes:
    if device.use_device(backend):
        from tpz.kernels import lzhuf_walk

        out = lzhuf_walk.decompress(data, orig_size,
                                    _dict_bits(method))
        if out is not None:
            return out
    return oracle.lzhuf_decode(data, orig_size, _dict_bits(method))


def compress(data: bytes, method: str = "lh5", level: int = 6,
             backend: str = "auto") -> bytes:
    _ = level
    body = raw_compress(data, method, backend=backend)
    return _MAGIC + method.encode() + struct.pack("<Q", len(data)) + body


def compress_many(datas, method: str = "lh5", level: int = 6,
                  backend: str = "auto") -> list[bytes]:
    """Batched lzhuf: one device stage-1/stage-2 invocation for every
    buffer (VERDICT r2 next #5 — amortizes the per-dispatch cost), or
    the oracle per buffer."""
    _ = level
    datas = list(datas)
    if device.use_device(backend):
        from tpz.kernels import lzhuf_pipeline

        bodies = lzhuf_pipeline.compress_many(datas, method)
    else:
        bits = _dict_bits(method)
        bodies = [oracle.lzhuf_encode(d, bits, 16) for d in datas]
    return [_MAGIC + method.encode() + struct.pack("<Q", len(d)) + b
            for d, b in zip(datas, bodies)]


def decompress_many(datas, method: str | None = None,
                    backend: str = "auto") -> list[bytes]:
    """Batch decode: on the device path every buffer's segments share
    one fused device walk; declines (counted in tpz.device.declines)
    take the host decoder per buffer."""
    datas = list(datas)
    parsed = []
    for d in datas:
        if len(d) < 15 or d[:4] != _MAGIC:
            raise DataError("bad lzhuf container magic")
        m = d[4:7].decode()
        if method is not None and m != method:
            raise DataError(f"container method {m} != requested {method}")
        (size,) = struct.unpack_from("<Q", d, 7)
        parsed.append((m, size, d[15:]))
    results = [None] * len(datas)
    if device.use_device(backend):
        from tpz.kernels import lzhuf_walk

        by_bits = {}
        for i, (m, size, body) in enumerate(parsed):
            by_bits.setdefault(_dict_bits(m), []).append(i)
        for bits, idxs in by_bits.items():
            outs = lzhuf_walk.decompress_many(
                [(parsed[i][2], parsed[i][1]) for i in idxs], bits)
            for i, o in zip(idxs, outs):
                results[i] = o
    return [r if r is not None else
            oracle.lzhuf_decode(b, s, _dict_bits(m))
            for r, (m, s, b) in zip(results, parsed)]


def decompress(data: bytes, method: str | None = None,
               backend: str = "auto") -> bytes:
    if len(data) < 15:  # 4 magic + 3 method + 8 size; body may be empty
        raise UnexpectedEof("lzhuf container too short")
    if data[:4] != _MAGIC:
        raise DataError("bad lzhuf container magic")
    m = data[4:7].decode()
    if method is not None and m != method:
        raise DataError(f"container method {m} != requested {method}")
    (size,) = struct.unpack_from("<Q", data, 7)
    return raw_decompress(data[15:], size, m, backend=backend)
