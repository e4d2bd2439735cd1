"""Burrows-Wheeler transform on device (SURVEY.md §2.1 BZip2 row: "BWT via
prefix-doubling radix sort"; §7 PR4).

Round-3 rewrite: CYCLIC prefix-doubling over width-N blocks (round 1/2
used a doubled-string s·s layout so shifted ranks were plain rolls, but
that formulation ties every suffix pair (i, i+n) to depth n — the early
exit never fired and every block paid all ~log2(N) rounds). The cyclic
rotation sort is exactly cpp/bzip2.cc BwtEncode's comparison
(rank[a], rank[(a+k) mod n]) with rotation-index tie-breaks, so
(last column, origPtr) stay bit-identical to the oracle — and real data
exits after ~5-7 rounds (rank distinctness over rotations, which the
doubled layout could never reach).

No scatters and no gathers: rank assignment writes back via an
inverse-permutation sort, and the cyclic shift r[(i+k) mod n] is applied
by sorting (key=(i-k) mod n, payload=r) — both ride the ~1 G keys/s
radix sort instead of the ~0.1 G elem/s gather/scatter path.

Blocks are padded to a static bucket size N (post-RLE1 block <= 900000);
pad cells carry +inf keys and never influence real ranks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("rounds",))
def _bwt_batched(w: jax.Array, n: jax.Array, rounds: int):
    """w: [NB, N] uint32 CYCLIC 4-byte big-endian words (w[i] packs
    s[i], s[(i+1) mod n], ..., built host-side by cyclic_words — same
    h2d volume as int32 bytes, but the initial rank sort starts at
    depth 4 instead of 2, saving a doubling round); n: [NB] int32 real
    lengths. Bytes derive as w >> 24. Returns (last [NB, N], orig [NB])."""
    NB, N = w.shape
    w = w.astype(jnp.uint32)
    d = jax.lax.shift_right_logical(w, jnp.uint32(24)).astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, N), 1)
    live = idx < n[:, None]

    def assign_ranks(k1, k2):
        """Rank positions by the (k1, k2) key pair; equal pairs share a
        rank (content equivalence), pads (INF keys) rank last."""
        sk1, sk2, sidx = jax.lax.sort((k1, k2, idx), dimension=1,
                                      num_keys=3)
        diff = ((sk1 != jnp.roll(sk1, 1, axis=1))
                | (sk2 != jnp.roll(sk2, 1, axis=1)))
        diff = diff.at[:, 0].set(True)
        ranks_sorted = jnp.cumsum(diff.astype(jnp.int32), axis=1)
        # Write back to position order via an inverse-permutation sort
        # (one 1-key sort instead of a scatter).
        _, r = jax.lax.sort((sidx, ranks_sorted), dimension=1, num_keys=1)
        return r

    def cyc_shift(r, k):
        """shifted[i] = r[(i + k) mod n] per row (k scalar or [NB]), for
        live i (pads INF), as a 1-key sort: element j lands at key
        (j - k) mod n."""
        kk = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (NB,))
        kk = jnp.where(n > 0, kk % jnp.maximum(n, 1), 0)[:, None]
        key = idx - kk
        key = jnp.where(key < 0, key + n[:, None], key)
        key = jnp.where(live, key, INF)
        _, shifted = jax.lax.sort((key, r), dimension=1, num_keys=1)
        return jnp.where(live, shifted, INF)

    def all_distinct(r):
        # All live ranks distinct <=> max live rank == live count. (The
        # cyclic domain has n entries, so this fires as soon as every
        # non-identical rotation pair is separated; identical rotations
        # of periodic inputs tie forever and break by index at the end.)
        mx = jnp.max(jnp.where(live, r, 0), axis=1)
        return jnp.all(mx >= n)

    # Depth-4 init: ONE single-key rank sort over the cyclic words.
    wkey = jnp.where(live, w, jnp.uint32(0xFFFFFFFF))
    swk, sidx0 = jax.lax.sort((wkey, idx), dimension=1, num_keys=1)
    diff0 = swk != jnp.roll(swk, 1, axis=1)
    diff0 = diff0.at[:, 0].set(True)
    rs0 = jnp.cumsum(diff0.astype(jnp.int32), axis=1)
    _, r = jax.lax.sort((sidx0, rs0), dimension=1, num_keys=1)

    def cond(carry):
        r, k, i = carry
        return (i < rounds) & ~all_distinct(r)

    def body(carry):
        r, k, i = carry
        r2 = assign_ranks(jnp.where(live, r, INF), cyc_shift(r, k))
        return r2, k * 2, i + 1

    r, _, _ = jax.lax.while_loop(cond, body,
                                 (r, jnp.int32(4), jnp.int32(0)))

    # Final order: rotations ordered by (rank, idx) — the index tie-break
    # for identical rotations of periodic inputs, as in cpp BwtEncode.
    # Rotation t contributes byte s[(t-1) mod n] to the last column at its
    # sorted position, so carrying the predecessor byte as a sort payload
    # yields `last` directly — no gather.
    rot_key = jnp.where(live, r, INF)
    prev_byte = cyc_shift(jnp.where(live, d, 0), n - 1)
    _, sa, last = jax.lax.sort((rot_key, idx, prev_byte), dimension=1,
                               num_keys=2)
    orig = jnp.argmax((sa == 0).astype(jnp.int32), axis=1).astype(jnp.int32)
    return last, orig


def cyclic_words(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[NB, N] uint8 + lengths -> [NB, N] uint32 big-endian 4-byte
    CYCLIC words (w[i] = s[i..i+3 mod n]); pad cells zero."""
    NB, N = blocks.shape
    # In-place mixed-dtype accumulation over a 3-byte-extended row
    # (round 5: the roll-temporary formulation cost ~3.8 s at 16 MiB on
    # this host; measured here, `u32 |= u8-slice` streams at memcpy
    # speed while a full-size astype alone costs 0.74 s — so never
    # materialize a u32 copy of the input).
    ext = np.concatenate([blocks, blocks[:, :3]], axis=1)
    w = np.zeros((NB, N), np.uint32)
    for s in (0, 1, 2, 3):
        w <<= 8
        w |= ext[:, s:N + s]
    # The extension wraps at the ROW end (N); fix the per-block wrap at
    # n (3 tail cells/row, whole rows for n < 4), then zero pad cells.
    for r in range(NB):
        n = int(lengths[r])
        lo = max(0, n - 3) if n >= 4 else 0
        row = blocks[r]
        for p in range(lo, n):
            w[r, p] = ((int(row[p]) << 24)
                       | (int(row[(p + 1) % n]) << 16)
                       | (int(row[(p + 2) % n]) << 8)
                       | int(row[(p + 3) % n]))
    pad = np.arange(N)[None, :] >= np.asarray(lengths)[:, None]
    w[pad] = 0
    return w


def bwt_blocks(blocks: np.ndarray, lengths: np.ndarray):
    """blocks: [NB, N] uint8 (zero-padded); lengths: [NB]. Returns
    (last [NB, N] uint8, orig [NB] int) computed on device."""
    from tpz import device

    NB, N = blocks.shape
    rounds = max(1, (N - 1).bit_length())  # bound; early exit is typical
    w = cyclic_words(blocks, lengths)
    last, orig = _bwt_batched(jnp.asarray(w),
                              jnp.asarray(lengths.astype(np.int32)), rounds)
    last, orig = device.fetch_many(last, orig)
    return last.astype(np.uint8), orig
