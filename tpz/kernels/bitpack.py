"""Variable-length bit packing on device (SURVEY.md §7 hard part 2).

Parity: the reference crate's BitWriter<Right> byte-serial loop
(src/bitio/writer.rs [MED]) becomes a data-parallel formulation: every
token contributes up to two (value, nbits) "slots" in position order;
since tokens are emitted in position order, the slot stream's exclusive
prefix sum of nbits gives each slot's absolute bit offset directly — no
compaction scatter needed. Each slot (≤28 bits) then lands in at most two
32-bit output words; a scatter-add over disjoint bit ranges assembles the
stream (add == or when ranges are disjoint).

Slot layout per input position p (LSB-first stream order):
  slot 2p   : literal code  OR  length code | length-extra bits
  slot 2p+1 : unused (literal) OR distance code | distance-extra bits
  one trailing slot per block: end-of-block code
Stored blocks instead use 8-bit byte slots at formula offsets
(32 KiB chunks, see cpp/deflate.cc kStoredChunk).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpz.kernels.matchfinder import BLOCK

STORED_CHUNK = 32768  # must match cpp/deflate.cc kStoredChunk


def _bitlen(x, maxbits):
    """bit_length via vector compares (elementwise, no table gather)."""
    c = jnp.zeros_like(x)
    for k in range(maxbits):
        c = c + (x >= (1 << k)).astype(jnp.int32)
    return c


def length_symbol(ml):
    """Closed-form RFC 1951 length symbol/extra for len 3..258.

    For len in 3..10: sym = 254 + len, 0 extra. For 11..257: with
    l = len - 3, e = bit_length(l) - 3 extra bits, sym = 257 + 4*(e+1) +
    ((l >> e) & 3) ... standard zlib structure. len == 258 -> sym 285,
    0 extra. Matches DEFLATE_LENGTH_SYM_TABLE exactly (tested).
    """
    l = jnp.maximum(ml - 3, 0)
    bl = _bitlen(l, 9)                       # bit_length(l)
    e = jnp.maximum(bl - 3, 0)               # extra bits
    sym_mid = 257 + 4 * (e + 1) + ((l >> e) & 3)
    sym = jnp.where(ml <= 10, 254 + ml, sym_mid)
    sym = jnp.where(ml >= 258, 285, sym)
    extra_bits = jnp.where((ml <= 10) | (ml >= 258), 0, e)
    extra_val = (l & ((jnp.int32(1) << e) - 1)).astype(jnp.uint32)
    extra_val = jnp.where((ml <= 10) | (ml >= 258), 0, extra_val)
    return sym, extra_bits, extra_val


def dist_symbol(md):
    """Closed-form RFC 1951 distance symbol/extra for dist 1..32768:
    d = dist - 1; e = max(bit_length(d) - 2, 0); sym = 2*(e+1) +
    ((d >> e) & 1) for d >= 4 else d. Matches the lo/hi tables (tested)."""
    d = jnp.maximum(md - 1, 0)
    bl = _bitlen(d, 16)
    e = jnp.maximum(bl - 2, 0)
    sym = jnp.where(d < 4, d, 2 * (e + 1) + ((d >> e) & 1))
    extra_val = (d & ((jnp.int32(1) << e) - 1)).astype(jnp.uint32)
    return sym, e, extra_val


def token_slots(data_block, is_token, mlen, mdist, lit_cl, dist_cl):
    """Build (values u32, nbits i32) slot arrays [NB, 2*BLOCK] for
    fixed/dynamic blocks.

    data_block: [NB, BLOCK] int32 bytes; is_token: [NB, BLOCK] bool;
    mlen/mdist: [NB, BLOCK] int32; lit_cl/dist_cl: [NB, 288]/[NB, 30]
    int32 packed (bit-reversed code) | (len << 16) — one gather serves
    both code and length.
    """
    is_match = is_token & (mlen > 0)
    is_lit = is_token & (mlen == 0)

    lsym, l_extra_bits, l_extra_val = length_symbol(jnp.clip(mlen, 0, 258))
    litlen_sym = jnp.where(is_match, lsym, data_block)
    ll = jnp.take_along_axis(lit_cl, litlen_sym, axis=1)
    ll_c = (ll & 0xFFFF).astype(jnp.uint32)
    ll_n = ll >> 16
    slot0_val = jnp.where(is_match, ll_c | (l_extra_val << ll_n), ll_c)
    slot0_n = jnp.where(is_match, ll_n + l_extra_bits,
                        jnp.where(is_lit, ll_n, 0))

    dsym, d_extra_bits, d_extra_val = dist_symbol(jnp.maximum(mdist, 1))
    dd = jnp.take_along_axis(dist_cl, jnp.clip(dsym, 0, 29), axis=1)
    d_c = (dd & 0xFFFF).astype(jnp.uint32)
    d_n = dd >> 16
    slot1_val = jnp.where(is_match, d_c | (d_extra_val << d_n), 0)
    slot1_n = jnp.where(is_match, d_n + d_extra_bits, 0)

    # Interleave: [NB, BLOCK, 2] -> [NB, 2*BLOCK].
    NB, BLOCK_ = data_block.shape
    vals = jnp.stack([slot0_val, slot1_val], axis=2).reshape(NB, 2 * BLOCK_)
    nbits = jnp.stack([slot0_n, slot1_n], axis=2).reshape(NB, 2 * BLOCK_)
    return vals, nbits


def assemble_stream_v2(data_block, is_token, mlen, mdist, table320,
                       body_off, btype, block_len, chunk1_off,
                       header, out_buf):
    """Compacted DEFLATE bitpack (round-2 stage2, byte-identical to
    assemble_stream + token_slots with far fewer scatter updates):

    1. Per-position slot SPECS are closed-form (symbol index into a
       combined 320-entry table, extra bits/value, live mask) — no code
       gathers at [NB, 2*BLOCK] geometry.
    2. One per-block sort compacts live slots to [NB, BLOCK+1] (live
       slots <= ntokens + nmatches + EOB <= BLOCK + 1), halving both the
       code-table gather volume and the scatter update count — XLA
       scatter costs per UPDATE (~0.14 G/s here), dead updates included.
    3. Codes are gathered only for compacted slots; bit offsets are the
       compacted exclusive prefix sum (stored chunk-1 slots add the
       32-bit-header gap recovered from their original column).

    table320: [NB, 320] int32 packed (bit-reversed code | len << 16):
    cols 0..287 litlen, 288..317 dist, 318/319 zero (raw-byte slots).
    header: (hvals, hnbits, hoffs) absolute-offset slots, scattered as-is.
    out_buf: zeroed uint32 [total_words + 2].
    """
    NB, B = data_block.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (NB, B), 1)
    stored = (btype == 0)[:, None]
    is_match = is_token & (mlen > 0)

    lsym, l_eb, l_ev = length_symbol(jnp.clip(mlen, 0, 258))
    dsym, d_eb, d_ev = dist_symbol(jnp.maximum(mdist, 1))

    # Slot 0: literal/length code (dyn+fixed) or raw byte (stored).
    live0 = jnp.where(stored, pos < block_len[:, None], is_token)
    idx0 = jnp.where(stored, 318, jnp.where(is_match, lsym, data_block))
    ev0 = jnp.where(stored, data_block.astype(jnp.uint32),
                    jnp.where(is_match, l_ev, 0))
    eb0 = jnp.where(stored, 8, jnp.where(is_match, l_eb, 0))
    # Slot 1: distance code (matches only).
    live1 = is_match & ~stored
    idx1 = 288 + jnp.clip(dsym, 0, 29)
    ev1 = jnp.where(live1, d_ev, 0)
    eb1 = jnp.where(live1, d_eb, 0)

    live = jnp.stack([live0, live1], axis=2).reshape(NB, 2 * B)
    idx = jnp.stack([idx0, idx1], axis=2).reshape(NB, 2 * B)
    extra = jnp.stack([(ev0 << 5) | jnp.asarray(eb0, jnp.uint32),
                       (ev1.astype(jnp.uint32) << 5)
                       | jnp.asarray(eb1, jnp.uint32)],
                      axis=2).reshape(NB, 2 * B)
    # EOB column (suppressed for stored blocks).
    live = jnp.concatenate([live, (btype != 0)[:, None]], axis=1)
    idx = jnp.concatenate([idx, jnp.full((NB, 1), 256, jnp.int32)], axis=1)
    extra = jnp.concatenate([extra, jnp.zeros((NB, 1), jnp.uint32)], axis=1)

    col = jax.lax.broadcasted_iota(jnp.uint32, (NB, 2 * B + 1), 1)
    key = ((~live).astype(jnp.uint32) << 18) | col
    skey, sidx, sextra = jax.lax.sort((key, idx, extra), dimension=1,
                                      num_keys=1)
    S = B + 1
    skey, sidx, sextra = skey[:, :S], sidx[:, :S], sextra[:, :S]
    slive = (skey >> 18) == 0
    scol = (skey & jnp.uint32(0x3FFFF)).astype(jnp.int32)

    cl = jnp.take_along_axis(table320, jnp.where(slive, sidx, 318), axis=1)
    clen = cl >> 16
    code = (cl & 0xFFFF).astype(jnp.uint32)
    seb = (sextra & 31).astype(jnp.int32)
    sev = sextra >> 5
    nbits = jnp.where(slive, clen + seb, 0)
    # Shift amount must be uint32: mixing int32 in demotes the value to
    # int32 (x64 disabled) and the scatter's `v >> (32 - sh)` then
    # sign-extends values with the top bit set (e.g. NLEN fields).
    val = jnp.where(slive, code | (sev << clen.astype(jnp.uint32)),
                    jnp.uint32(0))

    excl = jnp.cumsum(nbits, axis=1) - nbits
    off = body_off[:, None] + excl
    # Stored chunk 1: jump over the second chunk's 40-bit header (body_off
    # is chunk 0's data offset, so the gap is chunk1_off - body_off - 8c0).
    gap = jnp.where(chunk1_off > 0,
                    chunk1_off - body_off - 8 * STORED_CHUNK, 0)
    off = off + jnp.where(stored[:, :1] & ((scol >> 1) >= STORED_CHUNK),
                          gap[:, None], 0)

    # --- assemble words (round 3): compacted slot offsets are MONOTONE in
    # row-major order (positions ascend within a row, blocks are laid out
    # in stream order), and contributions to one word occupy disjoint bit
    # ranges, so sum == or. That turns the former 2-scatter (~33 M updates
    # per 16 MiB) into: cumsum over the contribution stream -> per-word value =
    # difference of the prefix at consecutive segment-lasts -> one parking
    # sort + a scatter of only ~cap_words updates. Headers (few, at
    # absolute offsets) keep a plain scatter.
    total_words = out_buf.shape[0] - 2
    n = off.size
    w0 = (off >> 5).reshape(-1)
    sh = (off & 31).astype(jnp.uint32).reshape(-1)
    v = val.reshape(-1)
    live = (nbits > 0).reshape(-1)
    lo = jnp.where(live, v << sh, jnp.uint32(0))
    hi = jnp.where(live & (sh > 0), v >> (jnp.uint32(32) - sh),
                   jnp.uint32(0))
    # Dead slots' offsets are NOT monotone for stored rows (the chunk-1
    # gap applies only to live columns); since they contribute 0, park
    # their word index on a sentinel — the extra zero-valued segments
    # land on the spare slot and every real difference stays exact.
    w0 = jnp.where(live, w0, jnp.int32(1 << 29))
    K = min(n, total_words + 2)
    words = out_buf
    for w, contrib in ((w0, lo), (w0 + 1, hi)):
        # u32 cumsum wraps mod 2^32; differences between segment-lasts
        # recover the exact word value (each true word value < 2^32).
        pref = jnp.cumsum(contrib)
        last = jnp.concatenate([w[1:] != w[:-1],
                                jnp.ones((1,), bool)])
        key = jnp.where(last, w, jnp.int32(1 << 30))
        skey, spref = jax.lax.sort((key, pref), num_keys=1,
                                   is_stable=True)
        skey, spref = skey[:K], spref[:K]
        wv = spref - jnp.concatenate(
            [jnp.zeros((1,), jnp.uint32), spref[:-1]])
        # Parked keys (and any out-of-range word) land on the spare slot
        # past total_words; it is sliced off below.
        idx = jnp.where(skey <= total_words, skey, total_words + 1)
        words = words.at[idx].add(wv, mode="drop",
                                  indices_are_sorted=True)
    hv, hn, ho = header
    hoff = ho.reshape(-1)
    hw0 = hoff >> 5
    hsh = (hoff & 31).astype(jnp.uint32)
    hvv = hv.astype(jnp.uint32).reshape(-1)
    hlive = hn.reshape(-1) > 0
    hlo = jnp.where(hlive, hvv << hsh, jnp.uint32(0))
    hhi = jnp.where(hlive & (hsh > 0), hvv >> (jnp.uint32(32) - hsh),
                    jnp.uint32(0))
    hw = jnp.where(hlive, hw0, total_words)
    words = words.at[hw].add(hlo, mode="drop")
    words = words.at[hw + 1].add(hhi, mode="drop")
    return words[:total_words]


def assemble_stream_msb(vals, nbits, body_off, total_words):
    """MSB-first bitpack (BZip2/LZHUF direction, SURVEY.md §1 bit-direction
    row): slots in position order per block, offsets = body_off + exclusive
    prefix sum. Word w holds stream bits [32w, 32w+32) with bit 32w at the
    word's MSB; the caller views the u32 array big-endian to get bytes.

    vals: [NB, S] uint32 (value's MSB written first), nbits: [NB, S] int32
    (<= 31), body_off: [NB] int32 absolute bit offsets.
    """
    excl = jnp.cumsum(nbits, axis=1) - nbits
    off = (body_off[:, None] + excl).reshape(-1)
    v = vals.reshape(-1)
    n = nbits.reshape(-1)
    # 64-bit big-endian window starting at word w0: value occupies bits
    # [shift, shift+n) from the top => left-shift by s = 64 - shift - n.
    w0 = off >> 5
    shift = (off & 31).astype(jnp.uint32)
    s = jnp.uint32(64) - shift - n.astype(jnp.uint32)
    s32 = s.astype(jnp.int32)
    hi = jnp.where(s32 >= 32, v << (s - 32).astype(jnp.uint32),
                   v >> (jnp.uint32(32) - s))
    lo = jnp.where(s32 >= 32, jnp.uint32(0), v << s)
    # s == 32 edge: v >> 0 fine; v << 32 avoided by the branch.
    live = n > 0
    hi = jnp.where(live, hi, 0)
    lo = jnp.where(live, lo, 0)
    # Same monotone-stream assembly as the LSB path (cumsum + parking
    # sort beats the per-update-priced scatter). Unlike the stored-chunk
    # LSB layout, MSB slot offsets are monotone even for dead slots (pure
    # cumsum), so deads keep their word and create no extra segments.
    # K slack: a word shared across a row boundary yields one duplicate
    # segment-last per row (the stable sort + scatter-add sums partials).
    K = min(w0.size, total_words + 2 + vals.shape[0])
    words = jnp.zeros((total_words + 2,), jnp.uint32)
    for w, contrib in ((w0, hi), (w0 + 1, lo)):
        pref = jnp.cumsum(contrib)
        last = jnp.concatenate([w[1:] != w[:-1], jnp.ones((1,), bool)])
        key = jnp.where(last, w, jnp.int32(1 << 30))
        skey, spref = jax.lax.sort((key, pref), num_keys=1,
                                   is_stable=True)
        skey, spref = skey[:K], spref[:K]
        wv = spref - jnp.concatenate(
            [jnp.zeros((1,), jnp.uint32), spref[:-1]])
        idx = jnp.where(skey <= total_words, skey, total_words + 1)
        words = words.at[idx].add(wv, mode="drop",
                                  indices_are_sorted=True)
    return words[:total_words]
