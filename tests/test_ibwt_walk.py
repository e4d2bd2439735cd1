"""Device inverse BWT by list ranking (tpz/kernels/ibwt_walk.py).

Reference crate parity anchor: BZip2 decode (SURVEY.md §2.1 BZip2 row,
§7.5).
"""

import numpy as np
import pytest

from tpz.kernels.ibwt_walk import ibwt_blocks_fast
from tpz.utils import corpus


def _bwt_np(s):
    """Rotation-sort BWT with rotation-index tie-breaks (matches
    cpp/bzip2.cc BwtEncode)."""
    s = bytes(s)
    n = len(s)
    d = s + s
    rots = sorted(range(n), key=lambda i: d[i:i + n])
    last = np.frombuffer(bytes(s[(i + n - 1) % n] for i in rots),
                         np.uint8).copy()
    return last, rots.index(0)


def _pack(cases, N):
    nb = len(cases)
    last = np.zeros((nb, N), np.uint8)
    lens = np.zeros(nb, np.int64)
    origs = np.zeros(nb, np.int64)
    for b, s in enumerate(cases):
        lc, o = _bwt_np(s)
        last[b, : len(s)] = lc
        lens[b] = len(s)
        origs[b] = o
    return last, lens, origs


def test_walk_matches_plaintext():
    rng = np.random.default_rng(11)
    cases = [
        bytes([7]),
        b"ab",
        bytes(rng.integers(0, 4, 100, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 255, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 256, dtype=np.uint8)),
        bytes(rng.integers(0, 4, 1000, dtype=np.uint8)),  # skewed chains
        bytes(corpus.text(900)),
    ]
    last, lens, origs = _pack(cases, 1024)
    got = ibwt_blocks_fast(last, lens, origs)
    assert got is not None
    for b, s in enumerate(cases):
        assert got[b, : lens[b]].tobytes() == s, b


def test_periodic_block_detected():
    """A periodic block's LF map splits into disjoint cycles; the iBWT
    must DETECT it (return None -> host decoder) rather than emit
    garbage."""
    cases = [b"banana_bandana_banana" * 30]
    last, lens, origs = _pack(cases, 1024)
    assert ibwt_blocks_fast(last, lens, origs) is None


def test_periodic_stream_end_to_end():
    """Pipeline-level: device decode of a stream whose block is exactly
    periodic post-RLE1 falls back to the host oracle and round-trips.
    (Craft: RLE1 is identity for runs < 4, so a period without 4-runs
    survives to the BWT input.)"""
    from tpz import oracle
    from tpz.kernels import bzip2_pipeline

    data = b"abc" * 4000
    enc = oracle.bzip2_encode(data, 1)
    out = bzip2_pipeline.decompress(enc)
    if out is not None:  # device path may decline; codec falls back
        assert out == data
    import bz2

    assert bz2.decompress(enc) == data


@pytest.mark.parametrize("nblocks", [1, 3])
def test_pipeline_decompress_uses_walk(nblocks):
    import bz2

    from tpz.kernels import bzip2_pipeline

    data = bytes(corpus.mixed(120_000 * nblocks, seed=5))
    enc = bz2.compress(data, 1)  # 100k blocks -> nblocks blocks
    out = bzip2_pipeline.decompress(enc)
    assert out == data
