"""All-device bzip2 decode (tpz/kernels/bzip2_walk.py; SURVEY.md §2.1
BZip2 row "as batched kernels", VERDICT r2 missing #1 decode half)."""

import bz2

import numpy as np
import pytest

from tpz import oracle
from tpz.kernels import bzip2_pipeline, bzip2_walk
from tpz.utils import corpus


@pytest.mark.parametrize("lvl", [1, 9])
def test_walk_decodes_foreign_streams(lvl):
    datas = [
        bytes(corpus.text(150_000)),
        bytes(corpus.mixed(250_000, seed=3)),
        b"hello hello hello world",
        bytes(corpus.repetitive(120_000)),
    ]
    for data in datas:
        enc = bz2.compress(data, lvl)
        out = bzip2_pipeline.decompress_walk(enc)
        assert out == data


def test_walk_decodes_own_streams():
    data = bytes(corpus.mixed(300_000, seed=8))
    enc = oracle.bzip2_encode(data, 1)
    assert bzip2_pipeline.decompress_walk(enc) == data


def test_walk_declines_gracefully():
    # Incompressible data overflows the record cap -> decline, NOT wrong
    # bytes; the codec-level fallback still round-trips.
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 256, 80_000, dtype=np.uint8))
    enc = bz2.compress(data, 1)
    out = bzip2_pipeline.decompress_walk(enc)
    assert out is None or out == data
    from tpz.codecs import bzip2 as codec

    assert codec.decompress(enc, backend="device") == data


def test_walk_rejects_corrupt_trailer():
    data = bytes(corpus.text(60_000))
    enc = bytearray(bz2.compress(data, 1))
    enc[-2] ^= 0x40  # combined-CRC byte
    assert bzip2_pipeline.decompress_walk(bytes(enc)) is None


def test_walk_corrupt_symbol_bits_decline():
    data = bytes(corpus.text(60_000))
    enc = bytearray(bz2.compress(data, 1))
    enc[len(enc) // 2] ^= 0xFF  # mid-symbol-stream corruption
    out = bzip2_pipeline.decompress_walk(bytes(enc))
    assert out is None or out != data  # never silently wrong


def test_records_match_reference_last_columns():
    """The walk's (byte, count) records expand to byte-identical BWT
    last columns vs the host reference (DecodeBlockToLast)."""
    import jax.numpy as jnp

    data = bytes(corpus.mixed(220_000, seed=5))
    enc = bz2.compress(data, 1)
    scan = oracle.bzip2_scan_headers(enc)
    nb = len(scan["sym_bits"])
    N = bzip2_pipeline._bucket(100016)
    scap = N + 8192
    sb = np.frombuffer(enc, np.uint8)
    slices = np.zeros((nb, scap), np.uint8)
    for b in range(nb):
        s0 = int(scan["sym_bits"][b]) // 8
        take = min(int((scan["end_bits"][b] + 7) // 8 + 1 - s0),
                   len(enc) - s0)
        slices[b, :take] = sb[s0:s0 + take]
    tab = bzip2_walk.build_tables(scan["lens"], scan["n_useds"])
    assert tab is not None
    sw = np.ascontiguousarray(slices).view(">u4").astype(np.int32)
    S = N + 128
    recs, meta = map(np.asarray, bzip2_walk._walk_call(
        jnp.asarray(scan["n_useds"].astype(np.int32)),
        jnp.asarray(scan["nsels"].astype(np.int32)),
        jnp.asarray((scan["sym_bits"] & 7).astype(np.int32)),
        jnp.asarray(sw), jnp.asarray(tab),
        jnp.asarray(scan["selectors"].astype(np.int32)),
        jnp.asarray(scan["mtf_init"].astype(np.int32)),
        S=S, interpret=True))
    assert (meta[:, 1] == 0).all()
    blob, offs, lens, origs, crcs = oracle.bzip2_scan_to_last(enc)
    for b in range(nb):
        nr = meta[b, 0]
        cnt = recs[b, :nr] >> 8
        byt = (recs[b, :nr] & 255).astype(np.uint8)
        last = np.repeat(byt, cnt)
        assert np.array_equal(last, blob[offs[b]:offs[b] + lens[b]]), b


def test_walk_fuzz_vs_bz2():
    """Foreign bz2 streams across levels and content shapes: the
    all-device route either declines or decodes byte-exactly."""
    rng = np.random.default_rng(123)
    for trial in range(8):
        n = int(rng.integers(1, 260_000))
        kind = trial % 3
        if kind == 0:
            data = bytes(corpus.mixed(n, seed=100 + trial))
        elif kind == 1:
            data = bytes(rng.integers(0, 8, n, dtype=np.uint8))
        else:
            data = bytes(corpus.text(n))
        lvl = int(rng.integers(1, 10))
        enc = bz2.compress(data, lvl)
        out = bzip2_pipeline.decompress_walk(enc)
        assert out is None or out == data, (trial, n, lvl)


def test_decompress_walk_many_batched():
    """Batch decode across streams: one fused dispatch per level
    bucket; declined streams (incompressible) fall back per stream at
    the codec level."""
    import tpz.api as api

    rng = np.random.default_rng(2)
    datas = [bytes(corpus.text(120_000)),
             bytes(corpus.mixed(180_000, seed=4)),
             b"",
             bytes(rng.integers(0, 256, 40_000, dtype=np.uint8))]
    blobs = [bz2.compress(d, 1) if d else oracle.bzip2_encode(b"", 1)
             for d in datas]
    outs = bzip2_pipeline.decompress_walk_many(blobs)
    for d, o in zip(datas, outs):
        assert o is None or o == d
    assert api.decompress_many(blobs, "bzip2", backend="device") == datas
    # mixed levels -> two jit groups
    blobs2 = [bz2.compress(datas[0], 1), bz2.compress(datas[1], 9)]
    outs2 = bzip2_pipeline.decompress_walk_many(blobs2)
    for d, o in zip(datas[:2], outs2):
        assert o == d


def test_walk_multistream_and_sharded_output():
    """Concatenated .bz2 streams — including the sharded encoder's
    multi-stream output — decode on the all-device route with per-stream
    EOS validation."""
    a = bytes(corpus.text(90_000))
    b = bytes(corpus.mixed(120_000, seed=12))
    cat = bz2.compress(a, 1) + bz2.compress(b, 1)
    out = bzip2_pipeline.decompress_walk(cat)
    assert out == a + b
    # sharded encoder output (multi-stream by construction)
    import jax

    from tpz.parallel.mesh import make_mesh, sharded_compress_bzip2

    data = bytes(corpus.mixed(500_000, seed=13))
    blob = sharded_compress_bzip2(data, make_mesh(
        min(4, len(jax.devices()))), level=1)
    assert bzip2_pipeline.decompress_walk(blob) == data
    # corrupted mid-stream EOS still rejected
    bad = bytearray(cat)
    first_len = len(bz2.compress(a, 1))
    bad[first_len - 3] ^= 0x10  # stream 1 combined CRC
    assert bzip2_pipeline.decompress_walk(bytes(bad)) is None
