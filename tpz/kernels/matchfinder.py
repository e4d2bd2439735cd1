"""LZSS match finding on device — the flagship kernel (SURVEY.md §2.1 LZSS
row: "batched-window match scan", §7 hard part 1).

Implements the same "parse spec v1" as cpp/lzss.cc, reformulated as
vector sorts and compares instead of hash-chain pointer chasing:

  candidates   The oracle's "K most recent previous positions with the same
               3-byte hash, within the window" is exactly "the K sorted-
               order predecessors" after sorting (hash, position) keys —
               one batched radix sort per block batch instead of a serial
               hash-table build.
  screening    Each candidate is scored by its clamped 8-byte LCP
               (two u32 word compares, gather-light); the winner is the
               candidate with the longest screen, ties to most-recent.
               The oracle implements the identical screen+winner rule.
  extension    The winner's full match length is the true LCP, computed
               from prefix-doubling rank arrays (7 batched sorts build
               ranks for lengths 4..256; a descending-level walk then
               yields LCP in 2 gathers per level) — no byte-at-a-time
               compare loop anywhere.

All arrays are [NB, M] — NB blocks processed batch-parallel, M = window
halo + block + forward pad. Data-parallel across blocks is the primary
scaling axis (SURVEY.md §2.2 DP row).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

WINDOW = 32768
BLOCK = 65536
FWD_PAD = 512          # forward pad: max_match rounded up + screen slack
M_TOTAL = WINDOW + BLOCK + FWD_PAD
HASH_BITS = 15
MAX_MATCH = 258
MIN_MATCH = 3
TOO_FAR = 4096
RANK_LEVELS = (4, 8, 16, 32, 64, 128, 256)


def hash3(words: jax.Array) -> jax.Array:
    """words: u32 little-endian 4-byte windows; hash of the low 3 bytes,
    identical to cpp/lzss.cc Hash3."""
    v = words & jnp.uint32(0x00FFFFFF)
    return (v * jnp.uint32(0x9E3779B1)) >> jnp.uint32(32 - HASH_BITS)


def words_at(data: jax.Array) -> jax.Array:
    """data: [NB, M] uint8-valued int32. Returns u32 little-endian 4-byte
    windows at every byte offset (elementwise shifts, no gathers)."""
    d = data.astype(jnp.uint32)
    b0 = d
    b1 = jnp.roll(d, -1, axis=1)
    b2 = jnp.roll(d, -2, axis=1)
    b3 = jnp.roll(d, -3, axis=1)
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def best_candidate_sorted(h: jax.Array, valid_insert: jax.Array,
                          words: jax.Array, cap_at: jax.Array, k: int,
                          window: int):
    """Screen all K candidates for every position entirely in sorted space.

    Sorting (hash<<17 | idx) makes each entry's K most recent same-hash
    predecessors its K sorted-order neighbors. The 8-byte screen words
    (words[p], words[p+4]) travel through the sort as payloads, so the
    K screening comparisons are vector rolls — zero gathers. One scatter
    per output returns the winner to position order.

    h/valid_insert/words: [NB, M]; cap_at: [NB, M] per-position cap
    (min(MAX_MATCH, block_end - p), <=0 outside the block region).
    Returns best_j [NB, M] (winning candidate position or -1) and
    best_screen [NB, M] (its clamped 8-byte LCP).
    """
    NB, M = h.shape
    idx = jax.lax.broadcasted_iota(jnp.uint32, (NB, M), 1)
    # Invalid positions get the max key: they sort last, after every real
    # entry, so they can never appear as a predecessor of a valid one.
    key = (h << jnp.uint32(17)) | idx
    key = jnp.where(valid_insert, key, jnp.uint32(0xFFFFFFFF))
    w4 = jnp.roll(words, -4, axis=1)
    skey, sw0, sw4, scap = jax.lax.sort(
        (key, words, w4, cap_at), dimension=1, num_keys=1)
    spos = (skey & jnp.uint32(0x1FFFF)).astype(jnp.int32)
    shash = skey >> jnp.uint32(17)
    sval = skey != jnp.uint32(0xFFFFFFFF)
    col = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 1)

    screen_cap = jnp.minimum(scap, 8)
    best_screen = jnp.full((NB, M), -1, jnp.int32)
    best_j = jnp.full((NB, M), -1, jnp.int32)
    for kk in range(1, k + 1):
        ph = jnp.roll(shash, kk, axis=1)
        pp = jnp.roll(spos, kk, axis=1)
        pv = jnp.roll(sval, kk, axis=1)
        pw0 = jnp.roll(sw0, kk, axis=1)
        pw4 = jnp.roll(sw4, kk, axis=1)
        dist = spos - pp
        ok = (col >= kk) & (ph == shash) & pv & sval & (dist <= window)
        z0 = _match_bytes_u32(sw0 ^ pw0)
        z4 = _match_bytes_u32(sw4 ^ pw4)
        s = jnp.where(z0 == 4, 4 + z4, z0)
        s = jnp.minimum(s, screen_cap)
        s = jnp.where(ok, s, -1)
        better = s > best_screen  # strict: ties keep the more recent
        best_screen = jnp.where(better, s, best_screen)
        best_j = jnp.where(better, pp, best_j)

    # Scatter winners back to position order.
    nbidx = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 0)
    out_j = jnp.full((NB, M), -1, jnp.int32)
    out_s = jnp.full((NB, M), -1, jnp.int32)
    out_j = out_j.at[nbidx, spos].set(best_j, mode="drop")
    out_s = out_s.at[nbidx, spos].set(best_screen, mode="drop")
    return out_j, out_s


def _bswap32(x: jax.Array) -> jax.Array:
    return (((x & jnp.uint32(0xFF)) << 24) | ((x & jnp.uint32(0xFF00)) << 8)
            | ((x >> 8) & jnp.uint32(0xFF00)) | (x >> 24))


def _eq_bytes_be(x: jax.Array) -> jax.Array:
    """Leading equal BYTES from a big-endian u32 xor value (0..4)."""
    return ((x < (1 << 24)).astype(jnp.int32) + (x < (1 << 16)).astype(jnp.int32)
            + (x < (1 << 8)).astype(jnp.int32) + (x == 0).astype(jnp.int32))


def suffix_screen_w(words: jax.Array, span_off: jax.Array,
                    span_len: jax.Array, r_neighbors: int, window: int,
                    block: int, max_match: int, screen_bytes: int,
                    restart: int = 0):
    """Spec-v3 sorted-space screening (cpp/lzss.cc BuildSuffixSpace +
    BestMatchSuffix candidate scan): sort every insertable in-halo position
    by its screen_bytes-byte big-endian prefix (ties by position; invalid
    positions carry a leading invalid flag KEY so they sort strictly after
    every valid suffix, mirroring the C++ array that simply omits them),
    then scan r_neighbors sorted neighbors in each direction with vector
    rolls, keeping the top-2 candidates by (clamped screen, recency).

    Returns (pk1, pk2, cap_at): all [NB, M] in position order. pk packs a
    candidate as ((j + 1) << 6) | (s + 1) — j the candidate M-index (-1
    none), s its LCP clamped to min(screen_bytes, cap); no-candidate packs
    to 0. Position order is restored by ONE inverse-permutation sort keyed
    on the sorted positions (they are a permutation of 0..M-1) instead of
    four XLA scatters.
    """
    NB, M = words.shape
    nw = screen_bytes // 4
    slc = _span_len_col(span_len, NB)
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 1)
    gpos = span_off[:, None] + (idx - window)
    insertable = ((gpos >= 0) & (gpos + MIN_MATCH <= slc)
                  & (idx < window + block))
    block_end_rel = jnp.minimum(
        jnp.full_like(idx, block + window),
        window + (slc - span_off[:, None]))
    cap_at = jnp.clip(block_end_rel - idx, 0, max_match)
    if restart:
        # Parse-restart rule (cpp/lzss.h LzssParams.restart): no match may
        # cross a restart-aligned sub-boundary within the block.
        assert restart & (restart - 1) == 0 and block % restart == 0
        cap_at = jnp.minimum(
            cap_at, jnp.int32(restart) - ((idx - window) & (restart - 1)))
    cap_at = jnp.where(idx >= window, cap_at, 0)

    wbe = _bswap32(words)
    flag = jnp.where(insertable, jnp.uint32(0), jnp.uint32(1))
    keys = [jnp.roll(wbe, -4 * t, axis=1) for t in range(nw)]
    ops = (flag, *keys, idx)
    sorted_ops = jax.lax.sort(ops, dimension=1, num_keys=nw + 2)
    sflag = sorted_ops[0]
    skeys = sorted_ops[1:1 + nw]
    spos = sorted_ops[1 + nw]
    sval = sflag == 0
    col = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 1)
    # cap in sorted order is a pure elementwise function of spos — cheaper
    # to recompute than to carry a fifth payload through the sort (HBM
    # liveness bounds the single-invocation batch size).
    scap = jnp.clip(jnp.minimum(jnp.full_like(spos, block + window),
                                window + (slc - span_off[:, None])) - spos,
                    0, max_match)
    if restart:
        scap = jnp.minimum(
            scap, jnp.int32(restart) - ((spos - window) & (restart - 1)))
    scap = jnp.where(spos >= window, scap, 0)
    screen_cap = jnp.minimum(scap, screen_bytes)

    j1 = jnp.full((NB, M), -1, jnp.int32)
    s1 = jnp.full((NB, M), -1, jnp.int32)
    j2 = jnp.full((NB, M), -1, jnp.int32)
    s2 = jnp.full((NB, M), -1, jnp.int32)

    def scan_dir(sign, j1, s1, j2, s2):
        for kk in range(1, r_neighbors + 1):
            sh = sign * kk
            pp = jnp.roll(spos, sh, axis=1)
            pv = jnp.roll(sval, sh, axis=1)
            in_bounds = (col >= kk) if sign > 0 else (col < M - kk)
            dist = spos - pp
            ok = (in_bounds & pv & sval & (pp < spos)
                  & (dist <= jnp.int32(window)))
            # LCP from the BE key words, chained while saturated.
            s = jnp.zeros((NB, M), jnp.int32)
            carry = jnp.ones((NB, M), bool)
            for t in range(nw):
                pk = jnp.roll(skeys[t], sh, axis=1)
                eq = _eq_bytes_be(skeys[t] ^ pk)
                s = s + jnp.where(carry, eq, 0)
                carry = carry & (eq == 4)
            s = jnp.minimum(s, screen_cap)
            s = jnp.where(ok, s, -1)
            # top-2 by (screen, recency): a strict total order since
            # positions are unique.
            beats1 = (s > s1) | ((s == s1) & (pp > j1))
            beats2 = (s > s2) | ((s == s2) & (pp > j2))
            j2 = jnp.where(beats1, j1, jnp.where(beats2, pp, j2))
            s2 = jnp.where(beats1, s1, jnp.where(beats2, s, s2))
            j1 = jnp.where(beats1, pp, j1)
            s1 = jnp.where(beats1, s, s1)
        return j1, s1, j2, s2

    j1, s1, j2, s2 = scan_dir(1, j1, s1, j2, s2)
    j1, s1, j2, s2 = scan_dir(-1, j1, s1, j2, s2)

    # Back to position order: spos is a permutation of 0..M-1 (idx was a
    # sort key), so sorting the packed payloads by spos IS the inverse
    # permutation — no scatters.
    pk1 = jnp.where(j1 >= 0, ((j1 + 1) << 6) | (s1 + 1), 0)
    pk2 = jnp.where(j2 >= 0, ((j2 + 1) << 6) | (s2 + 1), 0)
    _, opk1, opk2 = jax.lax.sort((spos, pk1, pk2), dimension=1, num_keys=1)
    return opk1, opk2, cap_at


def find_matches_v3(words: jax.Array, span_off: jax.Array,
                    span_len: jax.Array, r_neighbors: int = 8,
                    window: int = WINDOW, block: int = BLOCK,
                    max_match: int = MAX_MATCH, screen_bytes: int = 16,
                    lazy: bool = False, max_lazy: int = 258,
                    restart: int = 0):
    """Portable XLA spec-v3 matcher: suffix screening + exact rank-array
    extension of the top-2 saturated candidates + local lazy demotion.
    Token-identical to cpp/lzss.cc suffix_mode (greedy walk applied on the
    returned lengths). words: [NB, M] u32 LE 4-byte windows."""
    NB, M = words.shape
    pk1, pk2, cap_at = suffix_screen_w(
        words, span_off, span_len, r_neighbors, window, block, max_match,
        screen_bytes, restart)
    data = (words & jnp.uint32(0xFF)).astype(jnp.int32)
    p = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 1) + window
    nbi = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 0)
    j1b = (pk1[:, window:window + block] >> 6) - 1
    s1b = (pk1[:, window:window + block] & 63) - 1
    j2b = (pk2[:, window:window + block] >> 6) - 1
    s2b = (pk2[:, window:window + block] & 63) - 1
    cap = cap_at[:, window:window + block]
    screen_cap = jnp.minimum(cap, screen_bytes)

    ranks = build_ranks(words)
    ln1_full = lcp_from_ranks(ranks, p, jnp.maximum(j1b, 0), words, data, cap)
    ln2_full = lcp_from_ranks(ranks, p, jnp.maximum(j2b, 0), words, data, cap)
    sat1 = (s1b >= screen_cap) & (j1b >= 0)
    ln1 = jnp.where(sat1, ln1_full, jnp.maximum(s1b, 0))
    need2 = (j2b >= 0) & (s2b >= screen_cap) & (ln1 < cap) & sat1
    ln2 = jnp.where(need2, ln2_full, -1)
    use2 = ln2 > ln1
    mlen = jnp.where(use2, ln2, ln1)
    mj = jnp.where(use2, j2b, j1b)
    mdist = p - mj
    valid = (j1b >= 0) & (s1b >= MIN_MATCH) & (mlen >= MIN_MATCH)
    valid = valid & ~((mlen == MIN_MATCH) & (mdist > TOO_FAR))
    mlen = jnp.where(valid, mlen, 0)
    mdist = jnp.where(valid, mdist, 0)
    del nbi
    if lazy:
        # Local one-step lazy demotion (equivalent to the sequential probe:
        # the rule only inspects the RAW best length at p+1).
        nxt = jnp.concatenate(
            [mlen[:, 1:], jnp.zeros((NB, 1), jnp.int32)], axis=1)
        blen_col = jnp.minimum(
            jnp.maximum(_span_len_col(span_len, NB) - span_off[:, None], 0),
            block)
        pos = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 1)
        demote = ((mlen > 0) & (mlen < max_lazy) & (pos + 1 < blen_col)
                  & (nxt > mlen))
        mlen = jnp.where(demote, 0, mlen)
        mdist = jnp.where(demote, 0, mdist)
    return mlen, mdist


def build_ranks(words: jax.Array):
    """Prefix-doubling ranks. words: [NB, M] u32 4-byte windows.
    Returns dict level->rank [NB, M] int32 for level in RANK_LEVELS.
    Positions compare by their suffix of `level` bytes (padded data is
    compared as-is; callers clamp lengths to real bounds).
    """
    NB, M = words.shape
    nbidx = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 0)
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 1)

    def assign_ranks(k1, k2):
        # Sort by (k1, k2, idx); rank = cumsum of "differs from previous".
        sk1, sk2, sidx = jax.lax.sort((k1, k2, idx), dimension=1, num_keys=3)
        diff = (sk1 != jnp.roll(sk1, 1, axis=1)) | (sk2 != jnp.roll(sk2, 1, axis=1))
        diff = diff.at[:, 0].set(True)
        ranks_sorted = jnp.cumsum(diff.astype(jnp.int32), axis=1)
        r = jnp.zeros((NB, M), jnp.int32)
        return r.at[nbidx, sidx].set(ranks_sorted)

    ranks = {}
    # Split the u32 word into two non-negative int32 keys (lax.sort on
    # int32 would misorder values with the sign bit set).
    r = assign_ranks((words >> 1).astype(jnp.int32), (words & 1).astype(jnp.int32))
    ranks[4] = r
    for lvl in RANK_LEVELS[1:]:
        half = lvl // 2
        shifted = jnp.roll(r, -half, axis=1)
        # Past-the-end shifts wrap; wrapped values only affect the last
        # `half` columns, which lie in the forward pad and are clamped away.
        r = assign_ranks(r, shifted)
        ranks[lvl] = r
    return ranks


def lcp_from_ranks(ranks: dict, p: jax.Array, q: jax.Array, words: jax.Array,
                   data: jax.Array, cap: jax.Array) -> jax.Array:
    """Vectorized LCP of suffixes p and q ([NB, BLOCK] M-indices), clamped
    to cap. Descends rank levels 256..4, then refines the last <4 bytes
    with byte gathers."""
    NB = p.shape[0]
    nbidx = jax.lax.broadcasted_iota(jnp.int32, p.shape, 0)
    ln = jnp.zeros_like(p)
    cp, cq = p, q
    maxi = words.shape[1] - 1
    for lvl in reversed(RANK_LEVELS):
        r = ranks[lvl]
        a = r[nbidx, jnp.minimum(cp, maxi)]
        b = r[nbidx, jnp.minimum(cq, maxi)]
        take = (a == b) & (ln + lvl <= cap)
        ln = jnp.where(take, ln + lvl, ln)
        cp = jnp.where(take, cp + lvl, cp)
        cq = jnp.where(take, cq + lvl, cq)
    # Up to 3 remaining bytes (plus rank-level gaps are powers of two so the
    # descent can leave at most lvl-1 of each level... levels are 4..256 with
    # each exactly double the previous, so remaining < 4).
    for _ in range(3):
        a = data[nbidx, jnp.minimum(cp, maxi)]
        b = data[nbidx, jnp.minimum(cq, maxi)]
        take = (a == b) & (ln < cap)
        ln = jnp.where(take, ln + 1, ln)
        cp = jnp.where(take, cp + 1, cp)
        cq = jnp.where(take, cq + 1, cq)
    return jnp.minimum(ln, cap)


def _match_bytes_u32(x: jax.Array) -> jax.Array:
    """Number of leading zero BYTES of little-endian u32 xor value."""
    b0 = (x & jnp.uint32(0xFF)) == 0
    b1 = (x & jnp.uint32(0xFFFF)) == 0
    b2 = (x & jnp.uint32(0xFFFFFF)) == 0
    b3 = x == 0
    return (b0.astype(jnp.int32) + b1.astype(jnp.int32)
            + b2.astype(jnp.int32) + b3.astype(jnp.int32))


def _span_len_col(span_len, NB):
    """span_len may be a scalar (single span) or [NB] (per-block span
    lengths, for multi-buffer batches). Returns a broadcastable column."""
    sl = jnp.asarray(span_len)
    if sl.ndim == 0:
        return sl[None, None]
    return sl[:, None]


def screen_candidates(words: jax.Array, span_off: jax.Array,
                      span_len: jax.Array, k: int, window: int, block: int,
                      max_match: int):
    """Common prefix of find_matches: hash, per-position caps, sorted-space
    candidate screening, taking precomputed u32 4-byte windows (byte value
    at p = words[p] & 0xFF). Returns (best_j, best_screen, words, cap_at)
    — all [NB, M] (block region at columns [window, window+block)).

    span_off: [NB] block offset within its span; span_len: scalar or [NB]
    (per-block span length — blocks from different input buffers can share
    one batch; cross-span halos are neutralized by the insertable mask)."""
    NB, M = words.shape
    slc = _span_len_col(span_len, NB)
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, M), 1)
    gpos = span_off[:, None] + (idx - window)
    insertable = (gpos >= 0) & (gpos + MIN_MATCH <= slc)
    h = hash3(words)
    block_end_rel = jnp.minimum(
        jnp.full_like(idx, block + window),
        window + (slc - span_off[:, None]))
    cap_at = jnp.clip(block_end_rel - idx, 0, max_match)
    cap_at = jnp.where(idx >= window, cap_at, 0)
    bj, bs = best_candidate_sorted(h, insertable, words, cap_at, k, window)
    return bj, bs, words, cap_at


@functools.partial(jax.jit,
                   static_argnames=("k", "window", "block", "max_match"))
def find_matches(data: jax.Array, span_off: jax.Array, span_len: jax.Array,
                 k: int = 8, window: int = WINDOW, block: int = BLOCK,
                 max_match: int = MAX_MATCH):
    """Batched best-match search.

    data: [NB, M_TOTAL] int32 byte values — block b's bytes at
          [WINDOW : WINDOW+BLOCK], preceded by its 32 KiB window halo and
          followed by FWD_PAD forward bytes (zeros beyond the span).
    span_off: [NB] int32 — global span offset of each block's first byte.
    span_len: scalar int32 — total span length.

    Returns (match_len, match_dist): [NB, BLOCK] int32; match_len is 0
    where no spec-valid match exists. Identical to the oracle's per-
    position best_match (before parsing).
    """
    NB, M = data.shape
    bj, bs, words, cap_at = screen_candidates(
        words_at(data), span_off, span_len, k, window, block, max_match)

    p = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 1) + window
    best_j = bj[:, window:window + block]
    best_screen = bs[:, window:window + block]
    cap = cap_at[:, window:window + block]

    ranks = build_ranks(words)
    full = lcp_from_ranks(ranks, p, jnp.maximum(best_j, 0), words, data, cap)
    need_ext = best_screen >= jnp.minimum(8, cap)
    mlen = jnp.where(need_ext, full, jnp.maximum(best_screen, 0))
    mdist = p - best_j
    valid = (best_j >= 0) & (best_screen >= MIN_MATCH) & (mlen >= MIN_MATCH)
    # too-far rule (parse spec v1)
    valid = valid & ~((mlen == MIN_MATCH) & (mdist > TOO_FAR))
    mlen = jnp.where(valid, mlen, 0)
    mdist = jnp.where(valid, mdist, 0)
    return mlen, mdist
