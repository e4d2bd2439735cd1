"""Device bzip2 back half: multi-table Huffman coder + MSB bitpack
(SURVEY.md §2.1 BZip2 row: "multi-table Huffman with greedy table
refinement ... as batched kernels"; VERDICT r2 missing #1).

Mirrors cpp/bzip2.cc EncodeBlockFromMtf decision-for-decision so the
emitted bits are identical to the host coder:
  - table count by n_mtf thresholds,
  - initial table partition by cumulative frequency (incl. the
    take-at-least-one-symbol quirk),
  - kNIters=4 greedy refinement: per-50-symbol-group argmin cost (first
    minimum wins, like the C++ `<`), per-table freqs + 1, package-merge
    to 17 bits (shared with cpp/huffman.cc via
    deflate_plan_device.package_merge_lengths, pad=1<<30 for bzip2's
    <= ~900k frequency sums), canonical codes,
  - selectors MTF'd + unary, delta-coded lengths, MSB-first symbol bits.

Group costs are one matrix product: ghist [G, A] x lens [T, A] in bf16 with f32
accumulation is exact (counts <= 50, lengths <= 17). The only scatter is
the one-time group-histogram build.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpz.kernels.bitpack import assemble_stream_msb
from tpz.kernels.deflate_plan_device import (canonical_codes,
                                             package_merge_lengths)
from tpz.kernels.mtf import mtf_ranks

A = 258          # padded alphabet (n_used + 2 <= 258)
T = 6            # max tables
GROUP = 50
LIMIT = 17       # encoder code-length limit (cpp kCodeLenLimit)
PM_PAD = 1 << 30


def _bitlen(x, maxbits):
    c = jnp.zeros_like(x)
    for k in range(1, maxbits + 1):
        c = c + (x >= (1 << k)).astype(jnp.int32)
    return c


def encode_blocks(syms, sym_len, used, n_used, orig, block_crc):
    """syms [NB, S] int32 RLE2 symbols (EOB NOT included), sym_len [NB],
    used [NB, 256] 0/1, n_used [NB], orig [NB], block_crc [NB] uint32.

    Returns (vals uint32 [NB, SL], nbits int32 [NB, SL], total_bits [NB])
    — each block's complete bit stream as position-ordered slots (magic
    through symbols), ready for assemble_stream_msb at stream offsets.
    """
    NB, S = syms.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, S + 1), 1)
    eob = n_used + 1
    n_mtf = sym_len + 1
    alpha = n_used + 2
    # Symbol stream with EOB appended at column sym_len.
    symf = jnp.concatenate([syms, jnp.zeros((NB, 1), jnp.int32)], axis=1)
    symf = jnp.where(idx == sym_len[:, None], eob[:, None], symf)
    live_sym = idx <= sym_len[:, None]
    symc = jnp.clip(jnp.where(live_sym, symf, 0), 0, A - 1)

    # ---- group histograms (the one scatter) + per-block freqs ----
    G = (S + 1 + GROUP - 1) // GROUP
    gid = idx // GROUP
    bidx = jax.lax.broadcasted_iota(jnp.int32, (NB, S + 1), 0)
    flat_g = (bidx * G + gid).reshape(-1)
    ghist = jnp.zeros((NB * G, A), jnp.int32).at[
        jnp.where(live_sym.reshape(-1), flat_g, NB * G),
        symc.reshape(-1)].add(1, mode="drop")
    ghist = ghist.reshape(NB, G, A)
    freq = jnp.sum(ghist, axis=1)                        # [NB, A]

    # ---- table count thresholds (cpp EncodeBlockFromMtf) ----
    nt = (2 + (n_mtf >= 200).astype(jnp.int32)
          + (n_mtf >= 600).astype(jnp.int32)
          + (n_mtf >= 1200).astype(jnp.int32)
          + (n_mtf >= 2400).astype(jnp.int32))           # [NB]
    n_sel = (n_mtf + GROUP - 1) // GROUP

    # ---- initial partition by cumulative frequency ----
    # P[h] = sum freq[:h], h in 0..A (exclusive prefix).
    P = jnp.concatenate(
        [jnp.zeros((NB, 1), jnp.int32), jnp.cumsum(freq, axis=1)], axis=1)
    h = jnp.arange(A + 1, dtype=jnp.int32)[None, :]
    lens = jnp.full((NB, T, A), 15, jnp.int32)
    total = n_mtf
    acc_lo = jnp.zeros((NB,), jnp.int32)
    sidx = jnp.arange(A, dtype=jnp.int32)[None, :]
    for t_rev in range(T):
        t = nt - 1 - t_rev                               # [NB]
        act = t_rev < nt
        target = total // jnp.maximum(t + 1, 1)
        pacc = jnp.take_along_axis(P, acc_lo[:, None], axis=1)
        cond = (h > acc_lo[:, None]) & (
            ((P - pacc) >= target[:, None]) | (h >= alpha[:, None]))
        hi = jnp.minimum(jnp.argmax(cond, axis=1).astype(jnp.int32),
                         alpha)
        # alpha == A with all symbols consumed: no h in [0, A] satisfies
        # cond (argmax returns 0) — the remaining tables get empty ranges,
        # like the C++ loop's hi == alpha.
        hi = jnp.where(acc_lo >= alpha, acc_lo, hi)
        in_rng = (sidx >= acc_lo[:, None]) & (sidx < hi[:, None])
        tl = jnp.where(in_rng & act[:, None], 2, 15)     # [NB, A]
        lens = lens.at[:, t_rev, :].set(
            jnp.where(act[:, None], tl, lens[:, t_rev, :]))
        acc_hi = jnp.take_along_axis(P, hi[:, None], axis=1)[:, 0]
        taken = acc_hi - pacc[:, 0]
        total = jnp.where(act, total - taken, total)
        acc_lo = jnp.where(act, hi, acc_lo)

    # ---- kNIters greedy refinement ----
    gcol = jax.lax.broadcasted_iota(jnp.int32, (NB, G), 1)
    g_live = gcol < n_sel[:, None]
    tcol = jnp.arange(T, dtype=jnp.int32)[None, :]
    ghist_bf = ghist.astype(jnp.bfloat16)
    scol = jnp.arange(A, dtype=jnp.int32)[None, None, :]
    sel = jnp.zeros((NB, G), jnp.int32)
    for _ in range(4):  # cpp kNIters
        cost = jnp.einsum("nga,nta->ngt", ghist_bf,
                          lens.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
        cost = jnp.where((tcol < nt[:, None])[:, None, :], cost, jnp.inf)
        sel = jnp.argmin(cost, axis=2).astype(jnp.int32)  # first min wins
        onehot = ((sel[:, :, None] == tcol[:, None, :]) & g_live[:, :, None])
        tfreq = jnp.einsum("ngt,nga->nta", onehot.astype(jnp.bfloat16),
                           ghist_bf,
                           preferred_element_type=jnp.float32)
        tfreq = tfreq.astype(jnp.int32)
        f = tfreq + (scol < alpha[:, None, None]).astype(jnp.int32)
        lens = package_merge_lengths(
            f.reshape(NB * T, A), LIMIT, pad=PM_PAD).reshape(NB, T, A)
    codes = canonical_codes(lens.reshape(NB * T, A),
                            LIMIT).reshape(NB, T, A)

    # ---- emission slots, per block in stream order ----
    u32 = jnp.uint32

    def mk(val, nb):
        return val.astype(u32), nb.astype(jnp.int32)

    one = jnp.ones((NB,), jnp.int32)
    # header: magic(24+24) crc(16+16) rand(1) orig(24) used16(16)
    #         used rows(16 x 16-or-0) ntables(3) nsel(15)
    used16_rows = used.reshape(NB, 16, 16)
    row_used = jnp.max(used16_rows, axis=2) > 0          # [NB, 16]
    w16 = jnp.arange(16, dtype=jnp.int32)
    used16 = jnp.sum(
        row_used.astype(jnp.int32) << (15 - w16)[None, :], axis=1)
    row_bits = jnp.sum(
        (used16_rows > 0).astype(jnp.int32) << (15 - w16)[None, None, :],
        axis=2)                                           # [NB, 16]
    hdr_vals = [
        mk(jnp.full((NB,), 0x314159, jnp.int32), 24 * one),
        mk(jnp.full((NB,), 0x265359, jnp.int32), 24 * one),
        mk((block_crc >> 16).astype(jnp.int32), 16 * one),
        mk((block_crc & 0xFFFF).astype(jnp.int32), 16 * one),
        mk(jnp.zeros((NB,), jnp.int32), one),            # randomized = 0
        mk(orig.astype(jnp.int32), 24 * one),
        mk(used16, 16 * one),
    ]
    for r in range(16):
        hdr_vals.append(mk(row_bits[:, r],
                           jnp.where(row_used[:, r], 16, 0)))
    hdr_vals.append(mk(nt, 3 * one))
    hdr_vals.append(mk(n_sel, 15 * one))
    hv = jnp.stack([v for v, _ in hdr_vals], axis=1)
    hn = jnp.stack([n for _, n in hdr_vals], axis=1)

    # selectors: MTF over table ids, unary (j ones + 0).
    selj = mtf_ranks(sel, n_sel, alpha=T)                # [NB, G]
    sel_val = ((u32(1) << selj.astype(u32)) - u32(1)) << u32(1)
    sel_nb = jnp.where(g_live, selj + 1, 0)

    # tables: per t: 5-bit start, then per symbol 2|delta|-bit steps + stop.
    prev = jnp.concatenate([lens[:, :, :1], lens[:, :, :-1]], axis=2)
    delta = lens - prev                                  # [NB, T, A]
    k = jnp.abs(delta)
    t_live = (tcol < nt[:, None])[:, :, None] & (scol < alpha[:, None, None])
    kk = k.astype(u32)
    step_mask = jnp.where(kk >= 16, u32(0xFFFFFFFF),
                          (u32(1) << (2 * kk)) - u32(1))
    step_val = jnp.where(delta > 0, u32(0xAAAAAAAA) & step_mask, step_mask)
    step_nb = jnp.where(t_live, 2 * k, 0)
    stop_nb = jnp.where(t_live, 1, 0)
    start_val = lens[:, :, 0].astype(u32)
    start_nb = jnp.where(tcol < nt[:, None], 5, 0)
    # interleave per table: [start][s0 steps][s0 stop][s1 steps][s1 stop]..
    tab_sv = jnp.stack([step_val, jnp.zeros_like(step_val)], axis=3)
    tab_sn = jnp.stack([step_nb, stop_nb], axis=3)
    tab_vals = jnp.concatenate(
        [start_val[:, :, None], tab_sv.reshape(NB, T, 2 * A)], axis=2)
    tab_nbs = jnp.concatenate(
        [start_nb[:, :, None], tab_sn.reshape(NB, T, 2 * A)], axis=2)
    tab_vals = tab_vals.reshape(NB, T * (2 * A + 1))
    tab_nbs = tab_nbs.reshape(NB, T * (2 * A + 1))

    # symbols: gather (code | len<<20) by (selector-of-group, symbol).
    packed = (codes | (lens << 20)).reshape(NB, T * A)
    sel_rep = jnp.repeat(sel, GROUP, axis=1)[:, :S + 1]
    gidx2 = jnp.clip(sel_rep, 0, T - 1) * A + symc
    pe = jnp.take_along_axis(packed, gidx2, axis=1)
    sym_vals = (pe & 0xFFFFF).astype(u32)
    sym_nbs = jnp.where(live_sym, pe >> 20, 0)

    vals = jnp.concatenate([hv, sel_val, tab_vals, sym_vals], axis=1)
    nbits = jnp.concatenate([hn, sel_nb, tab_nbs, sym_nbs], axis=1)
    total_bits = jnp.sum(nbits, axis=1)
    return vals, nbits, total_bits


@functools.partial(jax.jit, static_argnames=("cap_words",))
def encode_blocks_packed(syms, sym_len, used, n_used, orig, block_crc,
                         cap_words: int):
    """Full device back half: coder slots + MSB bitpack of every block at
    its absolute stream offset (blocks are bit-concatenated after the
    32-bit 'BZh<level>' stream header). Returns (words, end_bits)."""
    vals, nbits, total_bits = encode_blocks(
        syms, sym_len, used, n_used, orig, block_crc)
    body_off = 32 + jnp.cumsum(total_bits) - total_bits
    words = assemble_stream_msb(vals, nbits, body_off, cap_words)
    return words, body_off + total_bits
