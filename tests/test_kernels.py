"""Kernel micro-tests (SURVEY.md §4 item 4): numpy/C++ twins agree, the
pointer-doubling parse equals a sequential walk, and the device token
stream equals the oracle's tokens for parse specs v1 and v3."""

import jax.numpy as jnp
import numpy as np
import pytest


from tpz import oracle
from tpz.kernels import huffman as khuff
from tpz.utils import corpus


def test_package_merge_twin_matches_cpp():
    if not oracle.available():
        pytest.skip("oracle not built")
    rng = np.random.default_rng(0)
    for trial in range(30):
        n = int(rng.integers(2, 288))
        freqs = rng.integers(0, 1000, size=n).astype(np.uint32)
        freqs[rng.random(n) < 0.3] = 0
        for limit in (7, 15):
            if np.count_nonzero(freqs) > (1 << limit):
                continue  # impossible limit; both sides reject (not tested here)
            ours = khuff.package_merge_np(freqs, limit)
            ref = oracle.huff_lengths(freqs, limit)
            assert np.array_equal(ours, ref), (trial, limit, freqs.tolist())


def test_canonical_twin_matches_cpp():
    if not oracle.available():
        pytest.skip("oracle not built")
    rng = np.random.default_rng(1)
    for _ in range(20):
        freqs = rng.integers(0, 50, size=60).astype(np.uint32)
        lens = khuff.package_merge_np(freqs, 15)
        ours = khuff.canonical_codes_np(lens)
        ref = oracle.huff_canonical(lens)
        assert np.array_equal(ours, ref)


def test_device_tokens_match_oracle_tokens():
    """Parse spec v1 (hash screen, the LZHUF matcher) + greedy parse ==
    oracle LzssTokenize for the same spec."""
    if not oracle.available():
        pytest.skip("oracle not built")
    from tpz.kernels.deflate_pipeline import BLOCK, _make_words
    from tpz.kernels.matchfinder import FWD_PAD, WINDOW, find_matches
    from tpz.kernels.parse import greedy_parse

    data = corpus.mixed(100_000, seed=42)
    n = len(data)
    nb = (n + BLOCK - 1) // BLOCK
    span = np.zeros(WINDOW + nb * BLOCK + FWD_PAD, dtype=np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(data, np.uint8)
    words = _make_words(jnp.asarray(span))
    span_off = jnp.asarray((np.arange(nb) * BLOCK).astype(np.int32))
    block_len = jnp.asarray(
        np.minimum(n - np.arange(nb) * BLOCK, BLOCK).astype(np.int32))
    data_w = (words & jnp.uint32(0xFF)).astype(jnp.int32)
    mlen, mdist = find_matches(data_w, span_off, jnp.int32(n), k=32)
    is_token, _, _ = greedy_parse(mlen, mdist, block_len)
    mlen, mdist, is_token = map(np.asarray, (mlen, mdist, is_token))

    ref = oracle.lzss_tokenize(data)
    dev_tokens = []
    for b in range(nb):
        for p in np.nonzero(is_token[b])[0]:
            pos = b * BLOCK + int(p)
            ln = int(mlen[b, p])
            if ln >= 3:
                dev_tokens.append((pos, ln, 0, int(mdist[b, p])))
            else:
                dev_tokens.append((pos, 0, int(data[pos]), 0))
    ref_tokens = [tuple(t) for t in ref.tolist()]
    assert dev_tokens == ref_tokens


def _walk_reach(step, block_len):
    """Sequential greedy walk: positions p -> p + step[p] from 0."""
    reach = np.zeros(step.shape, bool)
    for b in range(step.shape[0]):
        p = 0
        while p < block_len[b]:
            reach[b, p] = True
            p += int(step[b, p])
    return reach


@pytest.mark.parametrize("seed,n", [(2, 256), (3, 1000), (4, 4096)])
def test_parse_doubling_matches_python_walk(seed, n):
    """_parse_doubling (log2(N) gather/scatter rounds) visits exactly the
    positions of the sequential chain, including jumps that overshoot the
    block end; greedy_parse masks positions past block_len."""
    from tpz.kernels.parse import _parse_doubling, greedy_parse

    rng = np.random.default_rng(seed)
    step = rng.integers(1, 9, size=(3, n)).astype(np.int32)
    step[rng.random(step.shape) < 0.1] = 100  # long jumps
    reach = np.asarray(_parse_doubling(jnp.asarray(step))) > 0
    full = np.full(3, n)
    assert np.array_equal(reach, _walk_reach(step, full))
    mlen = np.where(step >= 3, step, 0).astype(np.int32)
    blen = np.array([n, n - 17, n // 2], np.int32)
    is_tok, tok_idx, ntok = map(np.asarray, greedy_parse(
        jnp.asarray(mlen), jnp.zeros_like(jnp.asarray(mlen)),
        jnp.asarray(blen)))
    want = _walk_reach(np.where(mlen >= 3, mlen, 1), full)
    want &= np.arange(n)[None, :] < blen[:, None]
    assert np.array_equal(is_tok, want)
    assert np.array_equal(ntok, want.sum(axis=1))
    assert np.array_equal(tok_idx[want],
                          np.concatenate([np.arange(k) for k in ntok]))


def _v3_tokens(raw, n_blocks, window, block, restart, lazy):
    """Device spec-v3 tokens (find_matches_v3 + greedy parse) over a
    small-geometry block batch, as oracle-style (pos, len, lit, dist)."""
    from tpz.kernels import matchfinder as mf
    from tpz.kernels.parse import greedy_parse

    n = len(raw)
    data = np.frombuffer(raw, np.uint8)
    span = np.zeros(window + n_blocks * block + 512, np.uint8)
    span[window:window + n] = data
    m = window + block + 512
    idx = np.arange(n_blocks)[:, None] * block + np.arange(m)[None, :]
    words = mf.words_at(jnp.asarray(span[idx].astype(np.int32)))
    span_off = jnp.asarray((np.arange(n_blocks) * block).astype(np.int32))
    block_len = np.minimum(n - np.arange(n_blocks) * block,
                           block).astype(np.int32)
    mlen, mdist = mf.find_matches_v3(
        words, span_off, jnp.int32(n), 8, window=window, block=block,
        screen_bytes=16, lazy=lazy, restart=restart)
    is_tok, _, _ = greedy_parse(mlen, mdist, jnp.asarray(block_len))
    mlen, mdist, is_tok = map(np.asarray, (mlen, mdist, is_tok))
    toks = []
    for b in range(n_blocks):
        for p in np.nonzero(is_tok[b])[0]:
            pos = b * block + int(p)
            ln = int(mlen[b, p])
            toks.append((pos, ln, 0, int(mdist[b, p])) if ln >= 3
                        else (pos, 0, int(data[pos]), 0))
    return toks


@pytest.mark.parametrize("restart", [0, 256])
@pytest.mark.parametrize("lazy", [False, True])
def test_parse_v3_matches_oracle_tokens(lazy, restart):
    """The device spec-v3 parse (suffix screen + rank extension + local
    lazy demotion + pointer-doubling walk) == oracle suffix_mode, with a
    ragged tail block and with and without the restart rule."""
    window, block, n_blocks = 512, 1024, 3
    raw = corpus.mixed(n_blocks * block - 100, seed=321 + restart)
    toks = _v3_tokens(raw, n_blocks, window, block, restart, lazy)
    ref = oracle.lzss_tokenize(
        raw, oracle.params_array(window=window, max_chain=8,
                                 block_size=block, lazy=lazy, n_extend=2,
                                 screen_bytes=16, suffix_mode=True,
                                 restart=restart))
    assert toks == [tuple(t) for t in ref.tolist()]


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_v3_grouped_matches_ungrouped(lazy):
    """Blocks are independent rows: stage 1 over a batch split in two
    groups (the second ending in a ragged tail block) gives exactly the
    rows of the one-batch run."""
    from tpz.kernels.deflate_pipeline import _make_words, _stage1
    from tpz.kernels.matchfinder import BLOCK, FWD_PAD, WINDOW

    nb = 3
    n = nb * BLOCK - 4000
    data = corpus.mixed(n, seed=55)
    span = np.zeros(WINDOW + nb * BLOCK + FWD_PAD, np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(data, np.uint8)
    words = _make_words(jnp.asarray(span))
    span_off = jnp.asarray((np.arange(nb) * BLOCK).astype(np.int32))
    block_len = jnp.asarray(
        np.minimum(n - np.arange(nb) * BLOCK, BLOCK).astype(np.int32))
    whole = _stage1(words, span_off, jnp.int32(n), block_len, 8, lazy)
    parts = [_stage1(words[g], span_off[g], jnp.int32(n), block_len[g], 8,
                     lazy) for g in (slice(0, 1), slice(1, 3))]
    for i, a in enumerate(whole):
        b = np.concatenate([np.asarray(p[i]) for p in parts], axis=0)
        assert np.array_equal(np.asarray(a), b), i


@pytest.mark.parametrize("level", [1, 6])
def test_compress_many_uneven_batch_matches_oracle(level):
    """A batch whose first buffer ends exactly on a block boundary: the
    next buffer's bytes sit right behind it in the shared span and must
    not change its candidates near the end (each member equals the
    oracle's encode of that buffer alone)."""
    from tpz.codecs.deflate import DeflateConfig
    from tpz.kernels import deflate_pipeline as dp
    from tpz.kernels.matchfinder import BLOCK

    data = corpus.mixed(4 * BLOCK + 777, seed=30)
    datas = [data[:2 * BLOCK], data[2 * BLOCK:3 * BLOCK + 5],
             data[3 * BLOCK + 5:]]
    cfg = DeflateConfig(level=level)
    outs = dp.compress_many(datas, cfg)
    assert outs == [oracle.deflate_encode(d, cfg.params_array())
                    for d in datas]


@pytest.mark.slow
def test_parse_v3_fuzz_oracle_bytes():
    """Randomized end-to-end fuzz: the fused device encode stays
    byte-identical to the C++ oracle across levels, alphabets, sizes,
    and adversarial shapes (runs, incompressible)."""
    from tpz.codecs.deflate import DeflateConfig
    from tpz.kernels import deflate_pipeline as dp

    rng = np.random.default_rng(7)
    cases = []
    for trial in range(6):
        n = int(rng.integers(1_000, 220_000))
        kind = trial % 3
        if kind == 0:
            data = bytes(corpus.mixed(n, seed=100 + trial))
        elif kind == 1:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:
            data = bytes(
                np.repeat(rng.integers(60, 70, n // 50 + 1, dtype=np.uint8),
                          50)[:n].tobytes())
        lvl = int(rng.integers(1, 10))
        cases.append((data, lvl))
    for data, lvl in cases:
        cfg = DeflateConfig(level=lvl)
        blob = dp.compress(data, cfg)
        ref = oracle.deflate_encode(data, cfg.params_array())
        assert blob == ref, (len(data), lvl)
