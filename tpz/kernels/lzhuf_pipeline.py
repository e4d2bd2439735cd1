"""Device LZHUF encode pipeline (SURVEY.md §2.1 LZHUF row: "reuses LZSS +
Huffman + bitpack kernels with LHA parameters, MSB-first direction").

Same architecture as deflate_pipeline: device match-find/parse/histograms
(shared matchfinder with window 2^dictbits, block 32 KiB, max_match 256),
C++ host planning (cpp LzhufPlan — tables + header bits at absolute
offsets), device MSB bitpack, host OR-merge. Byte-identical to the
oracle's LzhufEncodeBytes (differential test in tests/test_lzhuf_pipeline).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpz import device
from tpz.constants import LZHUF_METHODS
from tpz.kernels import bitpack
from tpz.kernels.matchfinder import find_matches
from tpz.kernels.parse import greedy_parse

BLOCK = 32768
FWD = 512
MAX_MATCH = 256
NC = 510


def _shift_rows(base, k):
    if k == 0:
        return base
    if k >= base.shape[0]:
        return jnp.zeros_like(base)
    return jnp.concatenate(
        [jnp.zeros((k, base.shape[1]), base.dtype), base[:-k]], axis=0)


@functools.partial(jax.jit, static_argnames=("window",))
def _make_blocks(span_u8: jax.Array, window: int):
    nb = (span_u8.shape[0] - window - FWD) // BLOCK
    base = span_u8[window:window + nb * BLOCK].reshape(nb, BLOCK)
    parts = []
    q, r = divmod(window, BLOCK)
    if r:
        parts.append(_shift_rows(base, q + 1)[:, BLOCK - r:])
    for j in range(q, 0, -1):
        parts.append(_shift_rows(base, j))
    parts.append(base)
    parts.append(jnp.concatenate(
        [base[1:, :FWD], jnp.zeros((1, FWD), base.dtype)], axis=0))
    return jnp.concatenate(parts, axis=1).astype(jnp.int32)


def _bitlen16(p):
    """bit_length(p) for p in [0, 65536) via 16 vector compares."""
    c = jnp.zeros_like(p)
    for k in range(17):
        c = c + (p >= (1 << k)).astype(jnp.int32)
    return c


@functools.partial(jax.jit, static_argnames=("k", "window", "np_"))
def _stage1(blocks, span_off, span_len, block_len, k: int, window: int,
            np_: int):
    mlen, mdist = find_matches(blocks, span_off, span_len, k=k,
                               window=window, block=BLOCK,
                               max_match=MAX_MATCH)
    is_token, _, ntokens = greedy_parse(mlen, mdist, block_len)
    data_block = blocks[:, window:window + BLOCK]
    is_match = is_token & (mlen > 0)
    csym = jnp.where(is_match, 256 + mlen - 3, data_block)
    psym = _bitlen16(jnp.maximum(mdist, 1) - 1)

    NB = blocks.shape[0]
    bidx = jax.lax.broadcasted_iota(jnp.int32, (NB, BLOCK), 0)
    c_hist = jnp.zeros((NB, NC), jnp.int32).at[
        bidx, jnp.clip(csym, 0, NC - 1)].add(is_token.astype(jnp.int32))
    p_hist = jnp.zeros((NB, np_), jnp.int32).at[
        bidx, jnp.clip(psym, 0, np_ - 1)].add(is_match.astype(jnp.int32))
    return mlen, mdist, is_token, c_hist, p_hist, ntokens


@functools.partial(jax.jit, static_argnames=("total_words", "window"))
def _stage2(blocks, is_token, mlen, mdist, c_len, c_code, p_len, p_code,
            body_off, total_words: int, window: int):
    data_block = blocks[:, window:window + BLOCK]
    is_match = is_token & (mlen > 0)
    csym = jnp.where(is_match, 256 + mlen - 3,
                     jnp.where(is_token, data_block, 0))
    cc = jnp.take_along_axis(c_code, csym, axis=1).astype(jnp.uint32)
    cn = jnp.take_along_axis(c_len, csym, axis=1).astype(jnp.int32)
    slot0_val = cc
    slot0_n = jnp.where(is_token, cn, 0)

    p = jnp.maximum(mdist, 1) - 1
    c = _bitlen16(p)
    raw_bits = jnp.maximum(c - 1, 0)
    raw_val = (p.astype(jnp.uint32)
               & ((jnp.uint32(1) << raw_bits.astype(jnp.uint32))
                  - jnp.uint32(1)))
    pc = jnp.take_along_axis(p_code, jnp.clip(c, 0, 19), axis=1).astype(jnp.uint32)
    pn = jnp.take_along_axis(p_len, jnp.clip(c, 0, 19), axis=1).astype(jnp.int32)
    slot1_val = (pc << raw_bits.astype(jnp.uint32)) | raw_val
    slot1_n = jnp.where(is_match, pn + raw_bits, 0)

    NB = blocks.shape[0]
    vals = jnp.stack([slot0_val, slot1_val], axis=2).reshape(NB, 2 * BLOCK)
    nbits = jnp.stack([slot0_n, slot1_n], axis=2).reshape(NB, 2 * BLOCK)
    return bitpack.assemble_stream_msb(vals, nbits, body_off, total_words)


def compress(data: bytes, method: str = "lh5", max_chain: int = 16) -> bytes:
    return compress_many([data], method=method, max_chain=max_chain)[0]


def compress_many(datas, method: str = "lh5",
                  max_chain: int = 16) -> list[bytes]:
    """Batched LZHUF encode (VERDICT r2 next #5): ALL buffers' blocks
    share ONE stage-1 and ONE stage-2 device invocation — exactly the
    DEFLATE/bzip2 batching shape, amortizing the per-dispatch cost.
    Host planning (cpp LzhufPlan) stays per buffer; each
    buffer's bit stream packs at a word-aligned region of one shared
    output array. Byte-identical to the per-buffer path."""
    from tpz import oracle

    dict_bits, np_ = LZHUF_METHODS[method]
    window = 1 << dict_bits
    results = [None] * len(datas)
    idxs = [i for i, d in enumerate(datas) if len(d) > 0]
    for i, d in enumerate(datas):
        if len(d) == 0:
            results[i] = b""
    if not idxs:
        return results

    metas = []  # (i, nb, n)
    nbs = []
    for i in idxs:
        n = len(datas[i])
        nb = (n + BLOCK - 1) // BLOCK
        metas.append((i, nb, n))
        nbs.append(nb)
    NBtot = sum(nbs)
    M = window + BLOCK + FWD
    blocks_np = np.zeros((NBtot, M), np.uint8)
    span_off = np.zeros(NBtot, np.int32)
    span_len = np.zeros(NBtot, np.int32)
    block_len = np.zeros(NBtot, np.int32)
    r0 = 0
    for i, nb, n in metas:
        arr = np.frombuffer(memoryview(datas[i]), dtype=np.uint8)
        span = np.zeros(window + nb * BLOCK + FWD, dtype=np.uint8)
        span[window:window + n] = arr
        for b in range(nb):
            blocks_np[r0 + b] = span[b * BLOCK:b * BLOCK + M]
        span_off[r0:r0 + nb] = np.arange(nb) * BLOCK
        span_len[r0:r0 + nb] = n
        block_len[r0:r0 + nb] = np.minimum(
            n - np.arange(nb) * BLOCK, BLOCK)
        r0 += nb

    blocks = jnp.asarray(blocks_np.astype(np.int32))
    mlen, mdist, is_token, c_hist, p_hist, ntokens = _stage1(
        blocks, jnp.asarray(span_off), jnp.asarray(span_len),
        jnp.asarray(block_len), max_chain, window, np_)

    c_hist_np, p_hist_np, ntokens_np = (
        a.astype(np.uint32) for a in device.fetch_many(c_hist, p_hist,
                                                        ntokens))

    # Per-buffer host plans; each buffer's stream at a word-aligned
    # region of the shared output.
    body_off = np.zeros(NBtot, np.int64)
    plans = []
    region_bits = []
    pos_bits = 0
    r0 = 0
    for i, nb, n in metas:
        sl = slice(r0, r0 + nb)
        plan = oracle.lzhuf_plan(c_hist_np[sl], p_hist_np[sl],
                                 ntokens_np[sl], dict_bits)
        body_off[sl] = plan["body_off"] + pos_bits
        plans.append(plan)
        region_bits.append(pos_bits)
        pos_bits += (plan["total_bits"] + 31) // 32 * 32
        r0 += nb
    # Round the shared output up to a coarse bucket (128 KiB of words):
    # stage 2 must compile once per batch SHAPE, not once per batch
    # CONTENT — an exact word count changes with every input's bit total,
    # so each "warm" call would compile afresh. Per-buffer regions are
    # sliced out of the shared body below, so pad words are inert.
    total_words = max(1, -(-pos_bits // 32))
    total_words = -(-total_words // (1 << 15)) << 15

    words = _stage2(
        blocks, is_token, mlen, mdist,
        jnp.asarray(np.concatenate(
            [p["c_len"] for p in plans]).astype(np.int32)),
        jnp.asarray(np.concatenate(
            [p["c_code"] for p in plans]).astype(np.int32)),
        jnp.asarray(np.concatenate(
            [p["p_len"] for p in plans]).astype(np.int32)),
        jnp.asarray(np.concatenate(
            [p["p_code"] for p in plans]).astype(np.int32)),
        jnp.asarray(body_off.astype(np.int32)), total_words, window)
    body = device.fetch(words).astype(">u4").view(np.uint8)  # MSB-first

    for (i, nb, n), plan, rb in zip(metas, plans, region_bits):
        total_bytes = (plan["total_bits"] + 7) // 8
        out = plan["header"][:total_bytes].copy()
        out |= body[rb // 8:rb // 8 + total_bytes]
        results[i] = out.tobytes()
    return results
