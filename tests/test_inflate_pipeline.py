"""Device-parallel DEFLATE decode (VERDICT r1 #2): the encoder's 'TZ'
block index + header-only host scan + device symbol walk / pointer-doubling
match resolution must reproduce the plaintext exactly. Runs on CPU via the
XLA twin of the walk; the Pallas-Triton kernel runs compiled on the GPU."""

import gzip as stdgz

import numpy as np
import pytest

from tpz import oracle
from tpz.codecs import deflate, gzip_codec
from tpz.utils import corpus

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle library not built")


CASES = {
    "text": corpus.text(150_000),
    "mixed": corpus.mixed(200_000),
    "random": corpus.random_bytes(140_000),   # stored blocks, 2 chunks
    "repetitive": corpus.repetitive(100_000),  # long matches, deep chains
    "skewed": corpus.skewed_bytes(80_000),
    "small": b"hello hello hello hello",
    "one": b"x",
}


@pytest.mark.parametrize("name", list(CASES))
def test_indexed_decode_roundtrip(name):
    from tpz.kernels import inflate_pipeline as ip

    data = CASES[name]
    stream, bits, lens = deflate.compress_indexed(data, backend="device")
    assert bits is not None
    out = ip.decompress_indexed(stream, bits, lens)
    assert out == data


def test_indexed_decode_levels():
    from tpz.kernels import inflate_pipeline as ip

    data = corpus.mixed(150_000)
    for level in (1, 6, 9):
        stream, bits, lens = deflate.compress_indexed(data, level=level,
                                                      backend="device")
        out = ip.decompress_indexed(stream, bits, lens)
        assert out == data, f"level {level}"


def test_gzip_index_interop():
    """The FEXTRA side-car must not disturb any other decoder."""
    data = corpus.mixed(200_000)
    blob = gzip_codec.compress(data, backend="device")
    assert stdgz.decompress(blob) == data
    assert gzip_codec.decompress(blob) == data
    pos, extra = gzip_codec.parse_header_extra(blob, 0)
    idx = gzip_codec.parse_tz_extra(extra)
    assert idx is not None
    end_bits, out_lens = idx
    assert int(out_lens.sum()) == len(data)


def test_gzip_device_decode_forced():
    """backend='device' forces the device decode path end-to-end (the
    XLA twin on the CPU); CRC verification still guards it."""
    data = corpus.mixed(150_000)
    blob = gzip_codec.compress(data, backend="device")
    assert gzip_codec.decompress(blob, backend="device") == data


def test_gzip_corrupt_body_detected_on_device_path():
    data = corpus.text(150_000)
    blob = bytearray(gzip_codec.compress(data, backend="device"))
    pos, extra = gzip_codec.parse_header_extra(bytes(blob), 0)
    blob[pos + 5000] ^= 0xFF  # flip bits mid-body
    with pytest.raises(Exception):
        gzip_codec.decompress(bytes(blob), backend="device")


def test_scan_headers_matches_inflate():
    """Header scan agrees with the full inflate on block structure."""
    data = corpus.mixed(200_000)
    stream, bits, lens = deflate.compress_indexed(data, backend="device")
    scan = oracle.inflate_scan_headers(stream, np.asarray(bits))
    assert scan["btype"].shape[0] == len(bits)
    assert (scan["btype"] >= 0).all() and (scan["btype"] <= 2).all()
    # body bits lie inside their blocks
    starts = np.concatenate([[0], np.asarray(bits)[:-1]])
    dyn = scan["btype"] != 0
    assert (scan["body_bit"][dyn] > starts[dyn]).all()
    assert (scan["body_bit"][dyn] < np.asarray(bits)[dyn]).all()


def test_decompress_many_indexed_batch():
    """Round-3: many independent streams decode in ONE fused device
    program (shared flat pointer space; short last blocks padded)."""
    from tpz.kernels import inflate_pipeline as ip

    datas = [corpus.text(100_000), corpus.repetitive(70_001),
             corpus.mixed(130_000), b"tiny", corpus.random_bytes(66_000)]
    items = []
    for d in datas:
        stream, bits, lens = deflate.compress_indexed(d, backend="device")
        items.append((stream, bits, lens))
    outs = ip.decompress_many_indexed(items)
    for d, o in zip(datas, outs):
        assert o == d


def test_resolution_large_batch():
    """Decode a batch crossing 1 MiB of flat output (mixed + repetitive
    so both shallow and deep match chains exercise the doubling loop)."""
    from tpz.kernels import inflate_pipeline as ip

    datas = [corpus.mixed(600_000, seed=3), corpus.repetitive(500_000)]
    items = []
    for d in datas:
        stream, bits, lens = deflate.compress_indexed(d, backend="device")
        items.append((stream, bits, lens))
    outs = ip.decompress_many_indexed(items)
    for d, o in zip(datas, outs):
        assert o == d


def test_segment_index_foreign_zlib_gzip():
    """Round-3 route 2 (SURVEY.md §7.4): FOREIGN streams — no encoder
    side-car — device-decode via the host segment indexer, covering
    block-table cuts, stored blocks, and split-match carries."""
    import gzip as sysgzip
    import zlib as syszlib

    from tpz.codecs import gzip_codec, zlib_codec
    from tpz.kernels import inflate_pipeline as ip

    data = corpus.mixed(400_000, seed=13)
    z = syszlib.compress(data, 9)
    out = zlib_codec.decompress(z, backend="device")
    assert out == data
    g = sysgzip.compress(data, 6)
    out = gzip_codec.decompress(g, backend="device")
    assert out == data
    # raw deflate with trailing garbage still rejected on the device path
    raw = z[2:-4]
    from tpz.codecs import deflate as dcodec
    import pytest as _pytest

    from tpz.errors import DataError as _DE

    with _pytest.raises(_DE):
        dcodec.decompress(raw + b"junk", backend="device")
    # batch API
    idx = ip.index_stream(raw)
    assert idx is not None and idx["consumed"] == len(raw)


def test_segment_index_own_oracle_stream():
    """tpz's own oracle-encoded streams (the > MAX_DEVICE_SPAN fallback
    shape, which emits no TZ side-car) device-decode via the indexer."""
    from tpz.codecs import deflate as dcodec

    data = corpus.mixed(300_000, seed=21)
    body = dcodec.compress(data, 6, backend="oracle")
    out = dcodec.decompress(body, backend="device")
    assert out == data


def test_api_decompress_backend_plumbing():
    import tpz.api as api

    data = corpus.text(50_000)
    for fmt in ("gzip", "zlib", "deflate"):
        c = api.compress(data, fmt, backend="oracle")
        assert api.decompress(c, fmt, backend="device") == data
        assert api.decompress(c, fmt) == data


def test_segment_indexer_fuzz_vs_stdlib():
    """Foreign zlib streams across levels/strategies/sizes: the segment
    route either declines or decodes byte-exactly (never silently
    wrong)."""
    import zlib as z

    from tpz.kernels import inflate_pipeline as ip

    rng = np.random.default_rng(99)
    for trial in range(12):
        n = int(rng.integers(1, 300_000))
        kind = trial % 3
        if kind == 0:
            data = bytes(corpus.mixed(n, seed=trial))
        elif kind == 1:
            data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        else:
            data = bytes(corpus.text(n))
        lvl = int(rng.integers(1, 10))
        raw = z.compress(data, lvl)[2:-4]
        idx = ip.index_stream(raw)
        if idx is None:
            continue
        out = ip.decompress_segmented(raw, idx)
        assert out == data, (trial, n, lvl)


def test_gzip_multimember_batched_decode():
    """Round 3: a multi-member gzip stream whose members all carry the
    TZ index (the sharded encoder's shape) decodes in ONE device batch;
    a corrupted member CRC still raises."""
    from tpz.codecs import gzip_codec as gz
    from tpz.errors import DataError as DE

    parts = [corpus.text(120_000), corpus.mixed(90_000, seed=9),
             corpus.repetitive(50_000)]
    blob = b"".join(gz.compress(p, backend="device") for p in parts)
    out = gz.decompress(blob, backend="device")
    assert out == b"".join(parts)
    bad = bytearray(blob)
    bad[-6] ^= 1  # last member's CRC field
    import pytest as _pt

    with _pt.raises(DE):
        gz.decompress(bytes(bad), backend="device")


def test_segment_route_corruption_never_silent():
    """Bit flips anywhere in a zlib stream: the segment device route
    must raise/decline, never return wrong bytes silently (Adler-32
    guards the body; the indexer guards structure)."""
    import zlib as z

    from tpz.codecs import zlib_codec as zc
    from tpz.errors import CompressionError

    data = bytes(corpus.mixed(120_000, seed=55))
    blob = z.compress(data, 6)
    rng = np.random.default_rng(4)
    for _ in range(10):
        bad = bytearray(blob)
        bad[int(rng.integers(2, len(blob) - 4))] ^= 1 << int(
            rng.integers(0, 8))
        try:
            out = zc.decompress(bytes(bad), backend="device")
            assert out == data  # flip was in a dont-care bit
        except CompressionError:
            pass


def test_api_decompress_many_gzip_batched():
    import tpz.api as api

    datas = [corpus.text(80_000), corpus.mixed(60_000, seed=1), b"",
             corpus.repetitive(30_000)]
    blobs = api.compress_many(datas, "gzip", backend="oracle")
    outs = api.decompress_many(blobs, "gzip", backend="device")
    assert outs == datas
    outs = api.decompress_many(blobs, "gzip")
    assert outs == datas
    # other formats route per buffer
    zb = api.compress_many(datas, "zlib", backend="oracle")
    assert api.decompress_many(zb, "zlib", backend="device") == datas


def test_segmented_batch_grouping(monkeypatch):
    """Sub-batching when the batch exceeds the packed-pointer span
    (exercised with a shrunken cap so CPU tests cover the split
    logic)."""
    import zlib as z

    from tpz.kernels import inflate_pipeline as ip

    datas = [corpus.text(90_000), corpus.mixed(80_000, seed=3),
             corpus.repetitive(70_000)]
    items = []
    for d in datas:
        raw = z.compress(d, 6)[2:-4]
        idx = ip.index_stream(raw)
        assert idx is not None
        items.append((raw, idx))
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN", 150_000)
    outs = ip.decompress_many_segmented(items)
    assert outs == datas
    # a single stream above the packed cap routes WIDE and still
    # decodes; above the wide cap it raises cleanly
    import pytest as _pt

    big = (items[0][0], items[0][1])
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN", 50_000)
    assert ip.decompress_many_segmented([big])[0] \
        == datas[0]
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN_WIDE", 50_000)
    with _pt.raises(Exception):
        ip.decompress_many_segmented([big])


def test_wide_resolution_routing(monkeypatch):
    """Streams above the packed-pointer span dispatch alone under the
    WIDE (unpacked ptr/val) resolution — exercised by shrinking the
    packed cap; output identical to the packed path."""
    import zlib as z

    from tpz.kernels import inflate_pipeline as ip

    datas = [corpus.mixed(200_000, seed=9), corpus.text(80_000)]
    items = []
    for d in datas:
        raw = z.compress(d, 6)[2:-4]
        idx = ip.index_stream(raw)
        assert idx is not None
        items.append((raw, idx))
    ref = ip.decompress_many_segmented(items)
    assert ref == datas
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN", 100_000)
    outs = ip.decompress_many_segmented(items)
    assert outs == datas  # 200k stream went wide; 80k stayed packed
