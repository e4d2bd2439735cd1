"""Device DEFLATE encode pipeline: the whole encode is ONE jitted
program (SURVEY.md §3.1 boundaries):

  stage1  haloed block batch -> parse spec v3 (suffix-space candidates,
          top-2 extension, lazy matching; tpz/kernels/matchfinder.py and
          parse.py) -> per-block symbol histograms.
  plan    on-device table planning (tpz/kernels/deflate_plan_device.py):
          block types, canonical tables, every header bit placed.
  stage2  token slots -> prefix-sum offsets -> scatter bitpack
          (tpz/kernels/bitpack.py), header bits in the same scatter.

The host only lays out the batch and slices each buffer's bytes out of
the fetched words. Byte-identical to cpp DeflateEncode with the same
DeflateConfig (both implement parse spec v3 and the same planner).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpz import device
from tpz.kernels import bitpack
from tpz.kernels.matchfinder import BLOCK, FWD_PAD, WINDOW
from tpz.kernels.parse import greedy_parse

# Single-batch limit for int32 bit offsets: worst case (incompressible ->
# stored blocks) costs just over 8 bits/byte, so bound at 9 bits/byte to
# keep 32*total_words + 31 inside int32 (ADVICE r1: 1<<28 was ~0.4% over).
MAX_SPAN = (2**31 - 1) // 9
# Single fused-invocation span bound, sized so the program's peak device
# memory stays under half of an 80 GB H100: compiled.memory_analysis()
# of the fused encode peaks at 7.9 GB for a 32 MiB span and 34.9 GB for
# 128 MiB (PERF.md). Bigger batches split
# into sequential dispatches (compress_many); a bigger single buffer is
# encoded by the C++ oracle, which is byte-identical.
MAX_DEVICE_SPAN = 128 << 20


@jax.jit
def _make_words(span_u8: jax.Array, bfinal: jax.Array | None = None):
    """span_u8: [WINDOW + nb*BLOCK + FWD_PAD] uint8 (leading WINDOW and
    trailing FWD_PAD are zero padding). Builds the haloed [nb, M_TOTAL]
    matrix of u32 little-endian 4-byte windows with pure shifts/reshapes —
    no gathers, no separate int32 byte matrix (byte at p = w & 0xFF), and
    the 4-byte windows are computed on the 1-D span so they are exact even
    across row boundaries.

    bfinal [nb] marks each buffer's last block: bytes past its end belong
    to the NEXT buffer of a batch and read as zeros there, exactly as past
    the end of a lone buffer (the screen sort's keys look up to 32 bytes
    ahead, so they would otherwise change the candidates near the end).

    Relies on WINDOW == BLOCK/2 and FWD_PAD <= BLOCK."""
    d = span_u8.astype(jnp.uint32)
    w = (d | (jnp.roll(d, -1) << 8) | (jnp.roll(d, -2) << 16)
         | (jnp.roll(d, -3) << 24))
    nb = (span_u8.shape[0] - WINDOW - FWD_PAD) // BLOCK
    base = w[WINDOW:WINDOW + nb * BLOCK].reshape(nb, BLOCK)
    # Halo/pad columns re-slice the same 1-D word array, so every word
    # reflects its true span context (row 0's halo words come from the
    # span's leading zero padding).
    prev_tail = jnp.concatenate(
        [w[:WINDOW][None, :], base[:-1, BLOCK - WINDOW:]], axis=0)
    next_head = jnp.concatenate(
        [base[1:, :FWD_PAD], jnp.zeros((1, FWD_PAD), w.dtype)], axis=0)
    words = jnp.concatenate([prev_tail, base, next_head], axis=1)
    if bfinal is None:
        return words
    col = jnp.arange(words.shape[1], dtype=jnp.int32)
    keep = jnp.clip(WINDOW + BLOCK - col, 0, 4)  # bytes inside the buffer
    mask = jnp.where(keep >= 4, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (8 * keep).astype(jnp.uint32))
                     - jnp.uint32(1))
    return jnp.where(bfinal[:, None], words & mask[None, :], words)


def _stage1_core(words: jax.Array, span_off: jax.Array, span_len: jax.Array,
                 block_len: jax.Array, k: int, lazy: bool = False,
                 screen_bytes: int = 16, max_lazy: int = 258,
                 restart: int = 0):
    """Parse spec v3 (suffix-space candidates, top-2 extension, max_lazy
    — cpp/lzss.cc suffix_mode) over words: [NB, M_TOTAL] u32 haloed
    4-byte windows (byte = w & 0xFF): find_matches_v3, then the
    pointer-doubling greedy parse. Returns (mlen, mdist, is_token,
    lit_hist, dist_hist, ntokens)."""
    from tpz.kernels.matchfinder import find_matches_v3

    mlen, mdist = find_matches_v3(
        words, span_off, span_len, k, screen_bytes=screen_bytes,
        lazy=lazy, max_lazy=max_lazy, restart=restart)
    is_token, _, ntokens = greedy_parse(mlen, mdist, block_len)
    data_block = (words[:, WINDOW:WINDOW + BLOCK]
                  & jnp.uint32(0xFF)).astype(jnp.int32)
    is_match = is_token & (mlen > 0)
    lsym, _, _ = bitpack.length_symbol(jnp.clip(mlen, 0, 258))
    lit_sym = jnp.where(is_match, lsym, data_block)
    dsym, _, _ = bitpack.dist_symbol(jnp.maximum(mdist, 1))

    lit_hist = _hist_by_sort(
        jnp.where(is_token, jnp.clip(lit_sym, 0, 287), 288), 288)
    dist_hist = _hist_by_sort(
        jnp.where(is_match, jnp.clip(dsym, 0, 29), 30), 30)
    return mlen, mdist, is_token, lit_hist, dist_hist, ntokens


def _hist_by_sort(sym: jax.Array, nbins: int) -> jax.Array:
    """Per-row histogram via 1-key sort + branchless vectorized binary
    search: hist[k] = lower_bound(k+1) - lower_bound(k) on the sorted row.

    Chosen over two [NB, BLOCK] scatter-add histograms when XLA scatters
    were priced per update; not yet re-measured on the GPU. Masked-out
    positions must be pre-set to `nbins` (they sort last, never counted)."""
    NB, B = sym.shape
    s = jax.lax.sort(sym, dimension=1)
    k = jnp.arange(nbins + 1, dtype=jnp.int32)[None, :]
    k = jnp.broadcast_to(k, (NB, nbins + 1))
    lb = jnp.zeros((NB, nbins + 1), jnp.int32)
    for bit in reversed(range(B.bit_length())):
        cand = lb + (1 << bit)
        v = jnp.take_along_axis(s, jnp.minimum(cand, B) - 1, axis=1)
        lb = jnp.where((cand <= B) & (v < k), cand, lb)
    return lb[:, 1:] - lb[:, :-1]


_stage1 = functools.partial(
    jax.jit, static_argnames=("k", "lazy", "screen_bytes", "max_lazy",
                              "restart"))(_stage1_core)


def _fused_encode_fn(span, span_off, span_len, block_len, buf_start, bfinal,
                     out_buf, tables, k: int, lazy: bool,
                     screen_bytes: int = 16, max_lazy: int = 258,
                     restart: int = 0):
    """The whole encode as ONE program (VERDICT r1 #1/#7): stage1 ->
    on-device planning (tpz/kernels/deflate_plan_device.py) -> stage2,
    with header bits emitted by the same scatter. No host round-trip, no
    program swap between stages; the only d2h is the final fetch.

    Output words are allocated at the static worst case (out_buf, just
    over 9 bits/byte; the capacity rides as an array shape, not a static,
    to dodge the jax 0.9.0 fastpath mis-dispatch across static variants);
    end_pos[NB] reports each block's exact end bit so the host can slice
    per-buffer bytes."""
    from tpz.kernels.deflate_plan_device import plan_device

    words = _make_words(span, bfinal)
    mlen, mdist, is_token, lit_hist, dist_hist, _ = _stage1_core(
        words, span_off, span_len, block_len, k, lazy, screen_bytes,
        max_lazy, restart)
    lit_hist = lit_hist.at[:, 256].set(0)
    # block_len == 0 marks padding blocks (sharded layouts; the batch path
    # never produces them — empty buffers are filtered host-side).
    plan = plan_device(lit_hist, dist_hist, block_len, buf_start, bfinal,
                       tables, live=block_len > 0)
    data_block = (words[:, WINDOW:WINDOW + BLOCK]
                  & jnp.uint32(0xFF)).astype(jnp.int32)
    NB = data_block.shape[0]
    table320 = jnp.concatenate(
        [plan["lit_cl"], plan["dist_cl"], jnp.zeros((NB, 2), jnp.int32)],
        axis=1)
    out = bitpack.assemble_stream_v2(
        data_block, is_token, mlen, mdist, table320, plan["body_off"],
        plan["btype"], block_len, plan["chunk1_off"],
        (plan["hdr_vals"], plan["hdr_nbits"], plan["hdr_offs"]), out_buf)
    return out, plan["end_pos"]


_fused_jit = jax.jit(_fused_encode_fn,
                     static_argnames=("k", "lazy", "screen_bytes",
                                      "max_lazy", "restart"))
_plan_tables_dev = None


def plan_tables_dev() -> dict:
    """The on-device planner's lookup tables, uploaded once."""
    global _plan_tables_dev
    if _plan_tables_dev is None:
        from tpz.kernels.deflate_plan_device import plan_tables

        _plan_tables_dev = {kk: jnp.asarray(v)
                            for kk, v in plan_tables().items()}
    return _plan_tables_dev


def cfg_statics(cfg) -> dict:
    """The fused encode's static arguments for a DeflateConfig."""
    return dict(k=cfg.max_chain, lazy=cfg.lazy,
                screen_bytes=cfg.screen_bytes, max_lazy=cfg.max_lazy,
                restart=cfg.restart)


def _fused_encode(span, span_off, span_len, block_len, buf_start, bfinal,
                  out_buf, cfg):
    """Dispatch wrapper: passes the planner's lookup tables as REAL
    arguments. jax 0.9.0 drops hoisted trace constants when a jitted
    function accumulates multiple input signatures ("Computation compiled
    for N inputs but called with M"), so nothing inside the fused program
    may close over non-scalar constants."""
    return _fused_jit(span, span_off, span_len, block_len, buf_start,
                      bfinal, out_buf, plan_tables_dev(), **cfg_statics(cfg))


def compress(data: bytes, cfg=None) -> bytes:
    """Device-pipeline raw DEFLATE encode."""
    return compress_many([data], cfg)[0]


def compress_indexed(data: bytes, cfg=None):
    """Encode one buffer and return (stream_bytes, block_end_bits,
    block_out_lens) — the block index that makes device-parallel decode
    possible (SURVEY.md §7.4 encoder-assisted side-car; stored in a gzip
    FEXTRA subfield by tpz/codecs/gzip_codec.py, which every conformant
    gzip decoder skips)."""
    res = compress_many([data], cfg, want_index=True)
    return res[0]


def encode_layout(datas, idxs):
    """Host layout of a batch: the haloed span and per-block arrays
    (span_off, span_len, block_len, buf_start, bfinal) plus the static
    output capacity in words and the per-buffer block counts."""
    nbs = [(len(datas[i]) + BLOCK - 1) // BLOCK for i in idxs]
    NB = sum(nbs)
    span = np.zeros(WINDOW + NB * BLOCK + FWD_PAD, dtype=np.uint8)
    span_off = np.empty(NB, np.int32)
    span_len = np.empty(NB, np.int32)
    block_len = np.empty(NB, np.int32)
    # Per-buffer flags: each buffer's first block starts a word-aligned
    # output region; its last block carries BFINAL.
    buf_start = np.zeros(NB, bool)
    bfinal = np.zeros(NB, bool)
    b0 = 0
    pos = WINDOW
    for i, nb_i in zip(idxs, nbs):
        d = datas[i]
        span[pos:pos + len(d)] = np.frombuffer(memoryview(d), np.uint8)
        span_off[b0:b0 + nb_i] = np.arange(nb_i) * BLOCK
        span_len[b0:b0 + nb_i] = len(d)
        block_len[b0:b0 + nb_i] = np.minimum(
            len(d) - np.arange(nb_i) * BLOCK, BLOCK)
        buf_start[b0] = True
        bfinal[b0 + nb_i - 1] = True
        pos += nb_i * BLOCK
        b0 += nb_i
    # Static worst-case output size: stored blocks cost < 8.01 bits/byte
    # + 69 bits/chunk + per-buffer word alignment; 9 bits/byte dominates.
    # Rounded up to 64k words to bound compile variants.
    total_len = sum(len(datas[i]) for i in idxs)
    cap_words = (9 * total_len + 31) // 32 + 3 * NB + 16
    cap_words = (cap_words + (1 << 16) - 1) >> 16 << 16
    return (span, span_off, span_len, block_len, buf_start, bfinal,
            cap_words, nbs)


def compress_many(datas, cfg=None, want_index: bool = False):
    """Batch-encode many independent buffers in ONE fused dispatch.

    Each buffer is its own DEFLATE stream (window reset between buffers);
    all buffers' blocks share the device batch, so the per-dispatch cost
    amortizes over the whole set — the production serving shape
    (SURVEY.md §2.2 DP row: independent streams are the scaling unit).
    Cross-buffer halo contamination is impossible: candidate insertability
    and per-position caps are derived from each block's own span bounds.
    """
    from tpz import oracle

    if cfg is None:
        from tpz.codecs.deflate import DeflateConfig

        cfg = DeflateConfig()
    results = [None] * len(datas)
    idxs = [i for i, d in enumerate(datas) if len(d) > 0]
    for i, d in enumerate(datas):
        if len(d) == 0:
            blob = oracle.deflate_encode(b"")
            results[i] = ((blob, np.array([8 * len(blob)], np.int64),
                           np.array([0], np.int64))
                          if want_index else blob)
    if not idxs:
        return results

    # Device memory bounds one fused invocation. Oversized batches split
    # into sequential sub-dispatches; an oversized SINGLE buffer can't
    # split mid-stream (later blocks' bit offsets depend on earlier
    # output), so it takes the C++ oracle — byte-identical to this
    # pipeline by construction.
    if sum(len(datas[i]) for i in idxs) > MAX_DEVICE_SPAN:
        for i in list(idxs):
            if len(datas[i]) > MAX_DEVICE_SPAN:
                blob = oracle.deflate_encode(datas[i], cfg.params_array())
                results[i] = (blob, None, None) if want_index else blob
                idxs.remove(i)
        group, group_bytes = [], 0
        for i in idxs:
            if group and group_bytes + len(datas[i]) > MAX_DEVICE_SPAN:
                for gi, blob in zip(group, compress_many(
                        [datas[g] for g in group], cfg, want_index)):
                    results[gi] = blob
                group, group_bytes = [], 0
            group.append(i)
            group_bytes += len(datas[i])
        if group:
            for gi, blob in zip(group, compress_many(
                    [datas[g] for g in group], cfg, want_index)):
                results[gi] = blob
        return results

    (span, span_off_np, span_len_np, block_len_np, buf_start_np, bfinal_np,
     cap_words, nbs) = encode_layout(datas, idxs)
    out_words, end_pos = _fused_encode(
        jnp.asarray(span), jnp.asarray(span_off_np),
        jnp.asarray(span_len_np), jnp.asarray(block_len_np),
        jnp.asarray(buf_start_np), jnp.asarray(bfinal_np),
        jnp.zeros((cap_words + 2,), jnp.uint32), cfg)
    # Fetch the small end_pos first, then only the live prefix of the
    # padded output (quantized to bound slice-program variants).
    end_pos_np = device.fetch(end_pos)
    used_words = (int(end_pos_np[-1]) + 31) // 32
    q = min((used_words + (1 << 16) - 1) >> 16 << 16, cap_words)
    body = device.fetch(out_words[:q]).view(np.uint8)

    b0 = 0
    start_bit = 0
    for i, nb_i in zip(idxs, nbs):
        end_bit = int(end_pos_np[b0 + nb_i - 1])
        nbytes = (end_bit - start_bit + 7) // 8
        blob = body[start_bit // 8 : start_bit // 8 + nbytes].tobytes()
        if want_index:
            ends = (end_pos_np[b0:b0 + nb_i].astype(np.int64) - start_bit)
            results[i] = (blob, ends,
                          block_len_np[b0:b0 + nb_i].astype(np.int64))
        else:
            results[i] = blob
        start_bit = (end_bit + 31) // 32 * 32
        b0 += nb_i
    return results
