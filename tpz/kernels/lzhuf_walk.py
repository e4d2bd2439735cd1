"""Device LZHUF decode (round 3; VERDICT r2 next #5's decode half).

The lzhuf analogue of the DEFLATE segment route: the host LzhufIndex
(cpp/lzhuf.cc) walks the token stream once — no output materialization —
cutting 64 KiB-output, token-aligned segments (also at every block's
table change) with split-match carries; a Pallas-Triton walk (one
program per segment) then decodes every segment's tokens in parallel, writing (kind, dist-1, len) markers
at output positions, and the shared dense resolution
(inflate_pipeline._resolve_doubling with dist_bias=1) expands matches.

MSB-first bit order (LHA), c alphabet 510 (literals + lengths 3..256),
p alphabet <= 20 giving the distance's bit count. Tables use the same
12-bit level-1 + 5-bit level-2 split as the bzip2 walk; constant-code
blocks (single-symbol tables) become tables whose entries consume 0
bits — the walk's natural semantics for them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpz.kernels.inflate_pipeline import (BLOCK, _KIND_LIT, _KIND_MATCH,
                                          _materialize_fn, _resolve_doubling)

NC = 510

# Table layout: 12-bit level-1 (4096 entries, 16 KiB) + 5-bit level-2
# chunks (32 entries per escaped prefix): all four tables (c/p x L1/L2)
# of a segment take 64 KiB, small enough to stay cache-resident during
# its walk and to replicate per segment. Codes run to 17 bits (LHA cap);
# a stream whose long codes overflow L2_CAP declines to the host
# decoder (build_tables returns None).
L1_BITS = 12
L1W = 1 << L1_BITS
L2_CAP = 4096


def build_tables(lens: np.ndarray, consts: np.ndarray, nsym: int):
    """lens [NBLK, nsym] uint8 -> (l1 [NBLK, L1W], l2 [NBLK, L2_CAP])
    int32 MSB canonical decode tables, or None when a block's long
    codes overflow L2_CAP. consts[b] >= 0 fills the whole level-1 with
    (const << 5 | 0) — a 0-bit always-match entry."""
    NB = lens.shape[0]
    l1 = np.zeros((NB, L1W), np.int32)
    l2 = np.zeros((NB, L2_CAP), np.int32)
    for b in range(NB):
        if consts[b] >= 0:
            l1[b, :] = int(consts[b]) << 5
            continue
        lr = lens[b, :nsym].astype(np.int64)
        order = np.lexsort((np.arange(nsym), lr))
        order = order[lr[order] > 0]
        if order.size == 0:
            continue
        ls = lr[order]
        c = 0
        prev = int(ls[0])
        l2n = 0
        esc = {}
        for i in range(ls.size):
            L = int(ls[i])
            c <<= L - prev
            prev = L
            sym = int(order[i])
            if L <= L1_BITS:
                lo = c << (L1_BITS - L)
                l1[b, lo:lo + (1 << (L1_BITS - L))] = (sym << 5) | L
            else:
                pre = c >> (L - L1_BITS)
                if pre not in esc:
                    if l2n + 32 > L2_CAP:
                        return None
                    esc[pre] = l2n
                    l1[b, pre] = (l2n << 5) | 31
                    l2n += 32
                suf = c & ((1 << (L - L1_BITS)) - 1)
                w = 1 << (L1_BITS + 5 - L)
                s0 = esc[pre] + (suf << (L1_BITS + 5 - L))
                l2[b, s0:s0 + w] = (sym << 5) | L
            c += 1
    return l1, l2


def _walk(stream_words, body_bit_local, out_len, start_pos, tab,
          walk: str = "reference"):
    """MSB token walk -> markers [NB, BLOCK] (dist stored as dist-1).

    tab: [NB, TW] fused decode tables per segment, TW = 2*(L1W+L2_CAP):
    [c L1 | c L2 | p L1 | p L2]. walk="triton" runs the Pallas-Triton
    kernel (one program per segment), "interpret" the same kernel in the
    Pallas interpreter, "reference" the lane-parallel XLA twin; all
    three write identical markers."""
    args = (stream_words, body_bit_local, out_len, start_pos, tab)
    if walk == "reference":
        return _walk_vz(*args)
    return _walk_triton(*args, interpret=(walk == "interpret"))


def _srl(x, s):
    return jax.lax.shift_right_logical(x, s)


def _bits_msb(w0, w1, w2, sh, off, n):
    """MSB-first: n bits starting sh+off into the 96-bit window. Shift
    amounts stay below 32 (the GPU leaves wider shifts undefined)."""
    b = sh + off
    wi = b >> 5
    s2 = b & 31
    lo = jnp.where(wi == 0, w0, jnp.where(wi == 1, w1, w2))
    hi = jnp.where(wi == 0, w1, jnp.where(wi == 1, w2, 0))
    v = jax.lax.shift_left(lo, s2) | jnp.where(
        s2 > 0, _srl(hi, (32 - s2) & 31), 0)
    return jnp.where(n > 0, _srl(v, (32 - n) & 31), 0)


def _token(w0, w1, w2, sh, tab_at):
    """Decode one LZHUF token from the window at bit sh; tab_at(off)
    reads the segment's fused table. The host indexer already walked
    these exact bits, so codes are valid (constant-code tables have
    clen == 0). Returns (nbits, adv, mark)."""
    OC2 = L1W
    OP1 = L1W + L2_CAP
    OP2 = 2 * L1W + L2_CAP
    zero = jnp.zeros_like(sh)
    l1b = zero + L1_BITS
    peekc = _bits_msb(w0, w1, w2, sh, zero, l1b)
    e1 = tab_at(peekc)
    esc = (e1 & 31) == 31
    e2 = tab_at(OC2 + _srl(e1, 5) + _bits_msb(w0, w1, w2, sh, l1b, zero + 5))
    e = jnp.where(esc, e2, e1)
    clen = e & 31
    csym = _srl(e, 5)

    is_match = csym >= 256
    mlen = jnp.clip(csym - 256 + 3, 3, 258)
    pk = _bits_msb(w0, w1, w2, sh, clen, l1b)
    pe1 = tab_at(OP1 + pk)
    pesc = (pe1 & 31) == 31
    pe2 = tab_at(OP2 + _srl(pe1, 5)
                 + _bits_msb(w0, w1, w2, sh, clen + l1b, zero + 5))
    pe = jnp.where(pesc, pe2, pe1)
    plen_ = pe & 31
    pc = _srl(pe, 5)
    raw_n = jnp.maximum(pc - 1, 0)
    raw = _bits_msb(w0, w1, w2, sh, clen + plen_, raw_n)
    # dist = pval + 1; markers store pval (= dist - 1).
    pval = jnp.where(pc > 1,
                     jax.lax.shift_left(zero + 1, jnp.clip(pc - 1, 0, 30))
                     | raw, pc)
    nbits = jnp.where(is_match, clen + plen_ + raw_n, clen)
    adv = jnp.where(is_match, mlen, 1)
    mark = jnp.where(is_match,
                     (_KIND_MATCH << 28) | jax.lax.shift_left(pval, 9) | mlen,
                     (_KIND_LIT << 28) | csym)
    return nbits, adv, mark


def _walk_triton(stream_words, body_bit_local, out_len, start_pos, tab,
                 interpret: bool = False):
    """Pallas-Triton walk: one single-warp program per segment walks its
    tokens in one launch, reading stream and tables straight from device
    memory and storing each marker as a scalar into zeroed rows."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    NB, SW = stream_words.shape
    TW = tab.shape[1]

    def kernel(bb_ref, ol_ref, sp_ref, s_ref, t_ref, z_ref, out_ref):
        del z_ref  # aliased to out_ref
        g = pl.program_id(0)
        sbase = g * SW
        tbase = g * TW
        obase = g * BLOCK
        outl = ol_ref[g]

        def body(st):
            bitpos, out_pos = st
            wc = jnp.minimum(bitpos >> 5, SW - 3)
            w0 = s_ref[sbase + wc]
            w1 = s_ref[sbase + wc + 1]
            w2 = s_ref[sbase + wc + 2]
            nbits, adv, mark = _token(w0, w1, w2, bitpos & 31,
                                      lambda i: t_ref[tbase + i])
            out_ref[obase + out_pos] = mark
            return bitpos + nbits, out_pos + adv

        jax.lax.while_loop(lambda st: st[1] < outl, body,
                           (bb_ref[g], sp_ref[g]))

    out = pl.pallas_call(
        kernel,
        grid=(NB,),
        out_shape=jax.ShapeDtypeStruct((NB * BLOCK,), jnp.int32),
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lzhuf_symbol_walk",
    )(body_bit_local, out_len, start_pos, stream_words.reshape(-1),
      tab.reshape(-1), jnp.zeros((NB * BLOCK,), jnp.int32))
    return out.reshape(NB, BLOCK)


def _walk_vz(stream_words, body_bit_local, out_len, start_pos, tab):
    """Lane-parallel XLA twin of the Triton walk, and its reference:
    every segment advances one token per loop trip in vector lanes
    (~7 gathers + 1 scatter per trip)."""
    NB, SW = stream_words.shape
    TW = tab.shape[1]
    s_flat = stream_words.reshape(-1)
    t_flat = tab.reshape(-1)
    seg = jnp.arange(NB, dtype=jnp.int32)
    s_base = seg * jnp.int32(SW)
    t_base = seg * jnp.int32(TW)

    def body(c):
        bitpos, out_pos, out = c
        act = out_pos < out_len
        wc = jnp.minimum(bitpos >> 5, jnp.int32(SW - 3))
        w0 = s_flat[s_base + wc]
        w1 = s_flat[s_base + wc + 1]
        w2 = s_flat[s_base + wc + 2]
        nbits, adv, mark = _token(w0, w1, w2, bitpos & 31,
                                  lambda i: t_flat[t_base + i])
        col = jnp.where(act, out_pos, jnp.int32(BLOCK))
        out = out.at[seg, col].set(mark, mode="drop")
        return (jnp.where(act, bitpos + nbits, bitpos),
                jnp.where(act, out_pos + adv, out_pos), out)

    def cond(c):
        return jnp.any(c[1] < out_len)

    init = (body_bit_local, start_pos,
            jnp.zeros((NB, BLOCK + 1), jnp.int32))
    final = jax.lax.while_loop(cond, body, init)
    return final[2][:, :BLOCK]


@functools.partial(jax.jit, static_argnames=("walk",))
def _decode_fn(stream_words, body_bit_local, out_len, start_pos, carry,
               dense_off, tab, walk: str = "reference"):
    NB = out_len.shape[0]
    markers = _walk(stream_words, body_bit_local, out_len, start_pos,
                    tab, walk=walk)
    words0 = jnp.zeros((NB, 1), jnp.int32)  # no stored blocks in lzhuf
    zeros = jnp.zeros((NB,), jnp.int32)
    markers = _materialize_fn(markers, words0, zeros + 1, zeros, zeros,
                              zeros, out_len, carry=carry)
    pos = jax.lax.broadcasted_iota(jnp.int32, (NB, BLOCK), 1)
    live = pos < out_len[:, None]
    key = jnp.where(live, dense_off[:, None] + pos, jnp.int32(2**31 - 1))
    mpark = jnp.where(live, markers, (_KIND_LIT << 28))
    _, dense = jax.lax.sort(
        (key.reshape(-1), mpark.reshape(-1)), dimension=0, num_keys=1)
    return _resolve_doubling(dense, dist_bias=1)


SLICE_BYTES = BLOCK + 16384  # lzhuf worst expansion ~ 9/8 + tables


def decompress(data: bytes, orig_size: int, dict_bits: int,
               walk: str | None = None) -> bytes | None:
    """Device decode of one lzhuf body. None = declined (caller uses the
    host decoder)."""
    return decompress_many([(data, orig_size)], dict_bits, walk)[0]


def decompress_many(items, dict_bits: int,
                    walk: str | None = None) -> list:
    """Batch decode: all buffers' segments share ONE fused device walk +
    resolution (valid streams' matches never reach before their own
    start, so the dense pointer space is shared safely; the indexer
    validated every distance). items: [(body_bytes, orig_size)].
    Entries come back None where declined."""
    from tpz import device, oracle
    from tpz.constants import LZHUF_METHODS

    if walk is None:
        walk = device.walk_mode()
    results = [None] * len(items)
    idxs = []
    parsed = []
    total = 0
    for i, (data, orig_size) in enumerate(items):
        if orig_size == 0:
            results[i] = b""
            continue
        if orig_size > (1 << 24):
            device.decline("lzhuf_span")
            continue
        idx = oracle.lzhuf_index(data, orig_size, dict_bits,
                                 seg_out=BLOCK)
        if idx is None or len(idx["out_lens"]) == 0:
            device.decline("lzhuf_index")
            continue
        spans = ((idx["end_bits"] + 7) // 8 + 1 - idx["seg_bits"] // 8)
        if int(spans.max()) > SLICE_BYTES:
            device.decline("lzhuf_slice")
            continue
        total += orig_size
        idxs.append(i)
        parsed.append((idx, spans))
    if not idxs:
        return results
    if total > (1 << 24):  # packed-pointer bound: split the batch
        half = len(idxs) // 2 or 1
        a = decompress_many([items[i] for i in idxs[:half]], dict_bits,
                            walk)
        b = decompress_many([items[i] for i in idxs[half:]], dict_bits,
                            walk)
        for i, r in zip(idxs[:half] + idxs[half:], a + b):
            results[i] = r
        return results

    np_ = next(v[1] for v in LZHUF_METHODS.values() if v[0] == dict_bits)
    # Fused-table build; a block whose long codes overflow L2 declines
    # that buffer to the host decoder (keeps idxs/parsed aligned).
    tabs = []
    kept = []
    for (i, (idx, spans)) in zip(idxs, parsed):
        cl1, cl2 = build_tables(idx["c_lens"], idx["c_consts"], NC) \
            or (None, None)
        pt = build_tables(idx["p_lens"], idx["p_consts"], np_)
        if cl1 is None or pt is None:
            device.decline("lzhuf_l2_overflow")
            continue
        pl1, pl2 = pt
        tabs.append((cl1, cl2, pl1, pl2))
        kept.append((i, (idx, spans)))
    if not kept:
        return results
    idxs = [i for i, _ in kept]
    parsed = [p for _, p in kept]
    nseg = sum(len(p[0]["out_lens"]) for p in parsed)
    slices = np.zeros((nseg, SLICE_BYTES), np.uint8)
    sym_local = np.zeros(nseg, np.int32)
    ol = np.zeros(nseg, np.int32)
    carry_len = np.zeros(nseg, np.int32)
    carry = np.zeros(nseg, np.int32)
    TW = 2 * (L1W + L2_CAP)
    tabr = np.zeros((nseg, TW), np.int32)
    s0r = 0
    for (i, (idx, spans)), (cl1, cl2, pl1, pl2) in zip(
            zip(idxs, parsed), tabs):
        data = items[i][0]
        k = len(idx["out_lens"])
        sb = np.frombuffer(data, np.uint8)
        for s in range(k):
            p0 = int(idx["seg_bits"][s]) // 8
            take = min(int(spans[s]), len(data) - p0)
            slices[s0r + s, :take] = sb[p0:p0 + take]
        sl = slice(s0r, s0r + k)
        sym_local[sl] = (idx["seg_bits"] & 7).astype(np.int32)
        ol[sl] = idx["out_lens"].astype(np.int32)
        cl = idx["carry_len"].astype(np.int32)
        carry_len[sl] = cl
        cv = ((idx["carry_dist"].astype(np.int32) - 1).clip(0) << 9) | cl
        carry[sl] = np.where(cl > 0, cv, 0)
        bid = idx["block_ids"]
        tabr[sl] = np.concatenate(
            [cl1[bid], cl2[bid], pl1[bid], pl2[bid]], axis=1)
        s0r += k
    dense_off = (np.cumsum(ol, dtype=np.int64) - ol).astype(np.int32)
    sw = np.ascontiguousarray(slices).view(">u4").astype(np.int32)
    out = _decode_fn(
        jnp.asarray(sw), jnp.asarray(sym_local), jnp.asarray(ol),
        jnp.asarray(carry_len), jnp.asarray(carry),
        jnp.asarray(dense_off), jnp.asarray(tabr), walk=walk)
    flat = device.fetch(out)
    pos = 0
    for i, (idx, _) in zip(idxs, parsed):
        n_out = int(idx["out_lens"].sum())
        results[i] = flat[pos:pos + n_out].tobytes()
        pos += n_out
    return results
