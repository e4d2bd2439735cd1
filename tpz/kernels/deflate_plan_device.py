"""On-device DEFLATE block planning (SURVEY.md §7 hard part 3, VERDICT r1
next-steps #1/#7): package-merge length limiting, canonical codes, the RFC
1951 §3.2.7 code-length (CL) RLE, block-type choice and header-bit slot
emission — all as fixed-shape batched array ops, bit-identical to the C++
host planner (cpp/deflate.cc PlanFromFreqs/ChooseBtype/EmitBlockHeader and
cpp/huffman.cc PackageMergeLengths/CanonicalCodes, differential-tested in
tests/test_plan_device.py).

With this, stage1 -> plan -> stage2 fuse into ONE jit program: no device->
host histogram fetch, no host planning, no program swap between stages.

Formulation notes:

* Package-merge runs in "selection count" space: list_l = stable-sorted
  merge of leaves and adjacent-pair packages of list_{l-1}, with items as
  packed int32 keys (weight << 10 | is_package << 9 | min_sym). Because the
  reference comparator (weight, leaves-first, min_sym) is a strict total
  order on distinct items and jax.lax.sort is stable, the device lists
  order identically to the C++ std::sort/std::merge lists. Code lengths
  then need only per-level LEAF PREFIX COUNTS: selecting the first
  t_l items of list_l takes its pk_l packages (always the first pk_l
  packages in pair order) and its a_l = t_l - pk_l smallest leaves, with
  t_{l-1} = 2 pk_l; length(leaf of weight-rank r) = #{l : r < a_l}.
* The CL RLE is emitted per-position: every joint-sequence position emits
  at most one CL token, chosen by closed-form chunk rules that replicate
  cpp/deflate.cc ClEncode's greedy loops exactly (16s in chunks of 6 after
  a leading literal; zero runs in 138-chunks emitting 18/17/literals).
* Block-type choice is a lax.scan over blocks (stored-block cost depends
  on the absolute bit position's byte phase; buffers start word-aligned).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from tpz import constants as C

NLIT = C.DEFLATE_NUM_LITLEN          # 288
NDIST = 30
NCL = 19
MAX_BITS = C.DEFLATE_MAX_BITS        # 15
MAX_CL_BITS = C.DEFLATE_MAX_CL_BITS  # 7
JOINT = NLIT + 32                    # joint CL sequence capacity (nlit<=288, ndist<=30)
STORED_CHUNK = 32768

_PAD = jnp.int32(1 << 29)


def plan_tables() -> dict:
    """Constant lookup tables used by the planner, as numpy arrays.

    Passed into the fused program as explicit arguments: jax 0.9.0 drops
    hoisted trace constants when re-executing a cached multi-signature jit
    ("Computation compiled for N inputs but called with M"), so nothing in
    plan_device may close over non-scalar constants."""
    from tpz.kernels.huffman import canonical_codes_np

    fixed_ll = np.asarray(C.DEFLATE_FIXED_LITLEN_LENGTHS, np.int32)
    fixed_dl = np.asarray(C.DEFLATE_FIXED_DIST_LENGTHS, np.int32)
    return {
        "len_extra": np.asarray(C.DEFLATE_LENGTH_EXTRA, np.int32),
        "dist_extra": np.asarray(C.DEFLATE_DIST_EXTRA, np.int32),
        "cl_order": np.asarray(C.DEFLATE_CL_ORDER, np.int32),
        "fixed_ll": fixed_ll,
        "fixed_dl": fixed_dl,
        "fixed_lc": canonical_codes_np(fixed_ll).astype(np.int32),
        "fixed_dc": canonical_codes_np(fixed_dl).astype(np.int32),
    }


def _sort1(x):
    return jax.lax.sort(x, dimension=1)


def package_merge_lengths(freqs: jax.Array, limit: int,
                          pad: int = 1 << 29) -> jax.Array:
    """freqs [NB, NS] int32 (>=0) -> lengths [NB, NS] int32.

    Bit-identical to cpp/huffman.cc PackageMergeLengths (n > 2^limit cannot
    happen for DEFLATE shapes: 288 < 2^15, 19 < 2^7).

    PRECONDITION (ADVICE r2): packed int32 keys are (weight << 10 | flags/
    sym), and package weights can reach sum(freqs) per row — so the row
    frequency sum must stay < 2^19 to keep every real key below _PAD
    (1 << 29); >= 2^21 would wrap negative. DEFLATE blocks satisfy this
    structurally (<= 65536 tokens + EOB per 64 KiB block => sum <= 65537 <
    2^19); a bigger BLOCK or frequency scaling needs a wider key packing.
    """
    # `pad` must exceed every real key (weight << 10 | flag/sym): DEFLATE
    # uses _PAD = 1<<29 (sum <= 65537 < 2^19); bzip2 blocks pass 1<<30
    # (sum <= ~900k + 258 < 2^20 keeps keys < 2^30). Symbols need <= 9
    # bits either way (288/258 alphabets).
    from tpz.kernels.matchfinder import BLOCK as _BLOCK

    assert _BLOCK + 1 < (1 << 19), (
        "package_merge_lengths int32 key packing requires sum(freqs) < 2^19"
    )
    NB, NS = freqs.shape
    sym = jax.lax.broadcasted_iota(jnp.int32, (NB, NS), 1)
    active = freqs > 0
    n = jnp.sum(active.astype(jnp.int32), axis=1)  # [NB]

    leafkey = jnp.where(active, (freqs << 10) | sym, pad)
    leaves = _sort1(leafkey)                        # sorted by (weight, sym)

    # Build lists 1..limit; keep per-level package-flag prefix sums.
    pkcums = []
    prev = jnp.concatenate([leaves, jnp.full((NB, NS), pad)], axis=1)  # C=2NS
    pkcums.append(jnp.zeros((NB, 2 * NS), jnp.int32))  # list_1: all leaves
    for _ in range(1, limit):
        a, b = prev[:, 0::2], prev[:, 1::2]
        valid = (b < pad)  # a < PAD implied (sorted); odd leftover dropped
        w = (a >> 10) + (b >> 10)
        msym = jnp.minimum(a & 511, b & 511)
        pkg = jnp.where(valid, (w << 10) | (1 << 9) | msym, pad)
        prev = _sort1(jnp.concatenate([leaves, pkg], axis=1))
        is_pkg = ((prev >> 9) & 1) * (prev < pad)
        pkcums.append(jnp.cumsum(is_pkg, axis=1))

    # Backward selection walk: t_limit = 2(n-1).
    t = jnp.maximum(2 * (n - 1), 0)                 # [NB]
    rank = jax.lax.broadcasted_iota(jnp.int32, (NB, NS), 1)
    len_by_rank = jnp.zeros((NB, NS), jnp.int32)
    for lvl in range(limit, 0, -1):
        pc = pkcums[lvl - 1]
        idx = jnp.clip(t - 1, 0, 2 * NS - 1)
        pk = jnp.where(t > 0, jnp.take_along_axis(pc, idx[:, None], axis=1)[:, 0], 0)
        a_l = t - pk
        len_by_rank = len_by_rank + (rank < a_l[:, None]).astype(jnp.int32)
        t = 2 * pk
    # n == 1: the single active symbol gets length 1.
    len_by_rank = jnp.where((n == 1)[:, None] & (rank == 0), 1, len_by_rank)

    # Scatter rank-order lengths back to symbol order.
    sym_of_rank = (leaves & 511).astype(jnp.int32)
    live = leaves < pad
    bidx = jax.lax.broadcasted_iota(jnp.int32, (NB, NS), 0)
    out = jnp.zeros((NB, NS), jnp.int32)
    out = out.at[bidx, jnp.where(live, sym_of_rank, 0)].max(
        jnp.where(live, len_by_rank, 0), mode="drop")
    return out


def canonical_codes(lengths: jax.Array, max_bits: int) -> jax.Array:
    """lengths [NB, NS] int32 -> canonical codes [NB, NS] int32, identical
    to cpp/huffman.cc CanonicalCodes (codes in (len, symbol) order)."""
    NB, NS = lengths.shape
    lvl = jnp.arange(max_bits + 1, dtype=jnp.int32)            # 0..max
    onehot = (lengths[:, :, None] == lvl[None, None, :])       # [NB, NS, L+1]
    cnt = jnp.sum(onehot.astype(jnp.int32), axis=1)            # [NB, L+1]
    cnt = cnt.at[:, 0].set(0)
    # next_code[l] = (next_code[l-1] + count[l-1]) << 1, next_code[0] = 0.
    nc = jnp.zeros((NB, max_bits + 1), jnp.int32)
    code = jnp.zeros((NB,), jnp.int32)
    cols = [jnp.zeros((NB,), jnp.int32)]
    for l in range(1, max_bits + 1):
        code = (code + cnt[:, l - 1]) << 1
        cols.append(code)
    nc = jnp.stack(cols, axis=1)                               # [NB, L+1]
    # rank within the same length class (symbols ascending).
    excl = jnp.cumsum(onehot.astype(jnp.int32), axis=1) - onehot.astype(jnp.int32)
    rank = jnp.sum(excl * onehot, axis=2)                      # [NB, NS]
    base = jnp.sum(nc[:, None, :] * onehot, axis=2)            # [NB, NS]
    return jnp.where(lengths > 0, base + rank, 0)


def bit_reverse(code: jax.Array, nbits: jax.Array, max_bits: int) -> jax.Array:
    """Reverse the low `nbits` bits of code (LSB-first stream order)."""
    rev = jnp.zeros_like(code)
    c = code
    for _ in range(max_bits):
        rev = (rev << 1) | (c & 1)
        c = c >> 1
    return jnp.where(nbits > 0, rev >> (max_bits - nbits), 0)


def _reverse_cummin(x):
    return jnp.flip(jax.lax.cummin(jnp.flip(x, axis=1), axis=1), axis=1)


def cl_tokens(joint: jax.Array, L: jax.Array):
    """Per-position CL RLE of the joint (litlen ++ dist) length sequence.

    joint: [NB, JOINT] int32 (entries at i >= L are ignored); L: [NB].
    Returns (emit [NB,JOINT] bool, sym, extra_bits, extra_val int32),
    emissions in position order == cpp ClEncode output order."""
    NB, J = joint.shape
    i = jax.lax.broadcasted_iota(jnp.int32, (NB, J), 1)
    valid = i < L[:, None]
    v = jnp.where(valid, joint, -1)
    prev = jnp.concatenate([jnp.full((NB, 1), -2, jnp.int32), v[:, :-1]], axis=1)
    run_start = valid & (v != prev)
    # segment start index at each position
    s = jax.lax.cummax(jnp.where(run_start, i, -1), axis=1)
    # segment end (exclusive): next run start after i, else L
    nxt = _reverse_cummin(jnp.where(run_start, i, jnp.int32(1 << 30)))
    nxt = jnp.concatenate([nxt[:, 1:], jnp.full((NB, 1), 1 << 30, jnp.int32)], axis=1)
    end = jnp.minimum(nxt, L[:, None])
    t = i - s
    R = end - s

    # v != 0: t==0 -> literal v; tail chunks of 6 after it.
    t2 = t - 1
    c6 = t2 // 6
    rem6 = (R - 1) - 6 * c6
    start6 = (t2 % 6) == 0
    nz_emit16 = (t > 0) & start6 & (rem6 >= 3)
    nz_lit_tail = (t > 0) & (rem6 < 3) & (rem6 >= 1)
    nz_emit = (t == 0) | nz_emit16 | nz_lit_tail

    # v == 0: chunks of 138.
    c138 = t // 138
    rem0 = R - 138 * c138
    q = jnp.minimum(rem0, 138)
    start138 = (t % 138) == 0
    z18 = start138 & (q >= 11)
    z17 = start138 & (q >= 3) & (q < 11)
    zlit = q < 3
    z_emit = z18 | z17 | zlit

    is_zero = v == 0
    emit = valid & jnp.where(is_zero, z_emit, nz_emit)
    sym = jnp.where(
        is_zero,
        jnp.where(z18, 18, jnp.where(z17, 17, 0)),
        jnp.where(nz_emit16, 16, v))
    extra_bits = jnp.where(
        is_zero, jnp.where(z18, 7, jnp.where(z17, 3, 0)),
        jnp.where(nz_emit16, 2, 0))
    extra_val = jnp.where(
        is_zero, jnp.where(z18, q - 11, jnp.where(z17, q - 3, 0)),
        jnp.where(nz_emit16, jnp.minimum(rem6, 6) - 3, 0))
    sym = jnp.where(emit, sym, 0)
    extra_bits = jnp.where(emit, extra_bits, 0)
    extra_val = jnp.where(emit, extra_val, 0)
    return emit, sym, extra_bits, extra_val


def plan_from_freqs(lit_hist: jax.Array, dist_hist: jax.Array,
                    tables: dict | None = None):
    """Device twin of cpp PlanFromFreqs. lit_hist [NB, 288] (EOB NOT
    counted; forced to 1 here), dist_hist [NB, 30]. Returns a dict of
    per-block planning arrays (lengths, codes bit-reversed, CL machinery,
    bit costs). `tables` = plan_tables() entries (see its docstring)."""
    if tables is None:
        tables = plan_tables()
    NB = lit_hist.shape[0]
    lit_hist = jnp.asarray(lit_hist, jnp.int32)
    lit_freq = lit_hist.at[:, 256].set(1)
    dist_freq = jnp.asarray(dist_hist, jnp.int32)

    len_extra = jnp.asarray(tables["len_extra"], jnp.int32)      # [29]
    dist_extra = jnp.asarray(tables["dist_extra"], jnp.int32)    # [30]
    extra_total = (
        jnp.sum(lit_freq[:, 257:286] * len_extra[None, :], axis=1)
        + jnp.sum(dist_freq * dist_extra[None, :], axis=1))

    lit_len = package_merge_lengths(lit_freq, MAX_BITS)
    dist_len = package_merge_lengths(dist_freq, MAX_BITS)
    lit_code = canonical_codes(lit_len, MAX_BITS)
    # C++ canonicalizes dist over 32 entries; entries 30/31 have freq 0 ->
    # len 0, which cannot change counts, so 30-wide is identical.
    dist_code = canonical_codes(dist_len, MAX_BITS)

    idx_l = jnp.arange(NLIT, dtype=jnp.int32)
    nlit = jnp.maximum(
        jnp.max(jnp.where((lit_len > 0) & (idx_l >= 257)[None, :],
                          idx_l[None, :] + 1, 0), axis=1), 257)
    idx_d = jnp.arange(NDIST, dtype=jnp.int32)
    ndist = jnp.maximum(
        jnp.max(jnp.where((dist_len > 0) & (idx_d >= 1)[None, :],
                          idx_d[None, :] + 1, 0), axis=1), 1)

    # joint = lit_len[0:nlit] ++ dist_len[0:ndist]
    j = jnp.arange(JOINT, dtype=jnp.int32)[None, :]
    di = jnp.clip(j - nlit[:, None], 0, NDIST - 1)
    lit_pad = jnp.pad(lit_len, ((0, 0), (0, JOINT - NLIT)))
    joint = jnp.where(j < nlit[:, None], lit_pad,
                      jnp.take_along_axis(dist_len, di, axis=1))
    L = nlit + ndist
    emit, cl_sym, cl_eb, cl_ev = cl_tokens(joint, L)

    cl_onehot = (cl_sym[:, :, None] == jnp.arange(NCL)[None, None, :]) & emit[:, :, None]
    cl_freq = jnp.sum(cl_onehot.astype(jnp.int32), axis=1)       # [NB, 19]
    cl_len = package_merge_lengths(cl_freq, MAX_CL_BITS)
    cl_code = canonical_codes(cl_len, MAX_CL_BITS)

    cl_order = jnp.asarray(tables["cl_order"], jnp.int32)
    cl_len_ord = jnp.take_along_axis(
        cl_len, jnp.broadcast_to(cl_order[None, :], (NB, NCL)), axis=1)
    oi = jnp.arange(NCL, dtype=jnp.int32)
    ncl = jnp.maximum(
        jnp.max(jnp.where((cl_len_ord > 0) & (oi >= 4)[None, :],
                          oi[None, :] + 1, 0), axis=1), 4)

    # dyn header bits: 14 + 3*ncl + sum(cl_len[sym] + extra_bits)
    cl_len_at = jnp.sum(cl_onehot * cl_len[:, None, :], axis=2)  # [NB, JOINT]
    dyn_header = (14 + 3 * ncl
                  + jnp.sum(jnp.where(emit, cl_len_at + cl_eb, 0), axis=1))

    fixed_ll = jnp.asarray(tables["fixed_ll"], jnp.int32)
    fixed_dl = jnp.asarray(tables["fixed_dl"], jnp.int32)
    dyn_body = (jnp.sum(lit_freq * lit_len, axis=1)
                + jnp.sum(dist_freq * dist_len, axis=1) + extra_total)
    fixed_body = (jnp.sum(lit_freq * fixed_ll[None, :], axis=1)
                  + jnp.sum(dist_freq * fixed_dl[None, :], axis=1)
                  + extra_total)

    return {
        "lit_len": lit_len, "lit_code": lit_code,
        "dist_len": dist_len, "dist_code": dist_code,
        "nlit": nlit, "ndist": ndist, "ncl": ncl,
        "cl_len": cl_len, "cl_code": cl_code, "cl_len_ord": cl_len_ord,
        "cl_emit": emit, "cl_sym": cl_sym, "cl_eb": cl_eb, "cl_ev": cl_ev,
        "cl_len_at": cl_len_at,
        "dyn_header_bits": dyn_header,
        "dyn_body_bits": dyn_body,
        "fixed_body_bits": fixed_body,
    }


def _stored_cost_parts(start, block_len):
    """Mirror cpp StoredCost for block_len <= 65536 (<= 2 chunks)."""
    c0 = jnp.minimum(block_len, STORED_CHUNK)
    c1 = block_len - c0
    pad0 = (8 - ((start + 3) & 7)) & 7
    cost0 = 3 + pad0 + 32 + 8 * c0
    # After chunk 0 the position is byte-aligned -> pad is always 5.
    cost1 = jnp.where(c1 > 0, 3 + 5 + 32 + 8 * c1, 0)
    return cost0 + cost1, pad0, c0, c1


def choose_btypes(dyn_cost_wo3, fixed_body, block_len, buf_start, dyn_header,
                  live=None):
    """lax.scan over blocks: block types, absolute offsets, block starts.

    dyn_cost_wo3 = dyn_header_bits + dyn_body_bits; fixed_body =
    fixed_body_bits; buf_start [NB] bool marks blocks that begin a new
    output buffer (word-aligned region); live [NB] bool (False = padding
    block that must emit nothing — sharded layouts pad trailing blocks).
    Returns dict with btype [NB], start [NB], body_off [NB], chunk1_off
    [NB] (-big when absent) and end_pos [NB] (bit position after each
    block)."""
    if live is None:
        live = jnp.ones(block_len.shape, bool)

    def step(pos, x):
        dynw, fixb, blen, bstart, dynh, lv = x
        pos = jnp.where(bstart, (pos + 31) & ~jnp.int32(31), pos)
        start = pos
        dyn_cost = 3 + dynw
        fixed_cost = 3 + fixb
        stored_cost, pad0, c0, c1 = _stored_cost_parts(start, blen)
        use_stored = (blen > 0) & (stored_cost < dyn_cost) & (stored_cost < fixed_cost)
        use_fixed = ~use_stored & (fixed_cost <= dyn_cost)
        btype = jnp.where(use_stored, 0, jnp.where(use_fixed, 1, 2))
        cost = jnp.where(use_stored, stored_cost,
                         jnp.where(use_fixed, fixed_cost, dyn_cost))
        body_off = jnp.where(
            use_stored, start + 3 + pad0 + 32,
            jnp.where(use_fixed, start + 3, start + 3 + dynh))
        chunk1_off = jnp.where(
            use_stored & (c1 > 0),
            start + 3 + pad0 + 32 + 8 * c0 + 3 + 5 + 32,
            jnp.int32(-(1 << 30)))
        btype = jnp.where(lv, btype, 0)  # padding blocks emit nothing
        end = start + jnp.where(lv, cost, 0)
        return end, (btype, start, body_off, chunk1_off, end)

    _, (btype, start, body_off, chunk1_off, end_pos) = jax.lax.scan(
        step, jnp.int32(0),
        (dyn_cost_wo3, fixed_body, block_len, buf_start, dyn_header, live))
    return {"btype": btype, "start": start, "body_off": body_off,
            "chunk1_off": chunk1_off, "end_pos": end_pos}


def header_slots(plan: dict, sched: dict, block_len: jax.Array,
                 bfinal: jax.Array, live=None):
    """Build the header-bit slot arrays [NB, H] (vals u32, nbits i32,
    offs i32) replicating EmitBlockHeader / EmitStored header bits at
    absolute offsets. H = 2 + 19 + JOINT + 2 (stored chunk slots).
    Padding blocks (live False) emit zero bits."""
    NB = block_len.shape[0]
    if live is None:
        live = jnp.ones((NB,), bool)
    btype = sched["btype"]
    start = sched["start"]
    stored = btype == 0
    dyn = btype == 2

    c0 = jnp.minimum(block_len, STORED_CHUNK)
    c1 = block_len - c0
    pad0 = (8 - ((start + 3) & 7)) & 7

    # Slot 0: BFINAL|BTYPE (3 bits). Stored: first chunk's 3 bits
    # (bfinal only when single-chunk).
    b0 = jnp.where(stored, (bfinal & (c1 == 0)).astype(jnp.int32),
                   bfinal.astype(jnp.int32))
    s0_val = (b0 | (btype << 1)).astype(jnp.uint32)
    s0_n = jnp.full((NB,), 3, jnp.int32)
    s0_off = start

    # Stored slot A: chunk0 LEN|NLEN (32 bits) at start+3+pad0.
    lennlen0 = (c0 | ((~c0 & 0xFFFF) << 16)).astype(jnp.uint32)
    sA_val = lennlen0
    sA_n = jnp.where(stored, 32, 0)
    sA_off = start + 3 + pad0

    # Stored slot B: chunk1 header 3+5pad+32 bits at chunk0 end. The 3
    # header bits (bfinal,00) and LEN|NLEN after 5 zero pad bits: emit as
    # one 40-bit region = two slots (3 bits, then 32 bits at +8).
    c1_start = start + 3 + pad0 + 32 + 8 * c0
    sB_val = jnp.where(c1 > 0, bfinal.astype(jnp.int32), 0).astype(jnp.uint32)
    sB_n = jnp.where(stored & (c1 > 0), 3, 0)
    sB_off = c1_start
    lennlen1 = (c1 | ((~c1 & 0xFFFF) << 16)).astype(jnp.uint32)
    sC_val = lennlen1
    sC_n = jnp.where(stored & (c1 > 0), 32, 0)
    sC_off = c1_start + 8

    # Dynamic header: HLIT|HDIST|HCLEN (14 bits) then 3-bit CL lengths in
    # kClOrder (ncl live) then per-position CL tokens.
    hd_val = ((plan["nlit"] - 257) | ((plan["ndist"] - 1) << 5)
              | ((plan["ncl"] - 4) << 10)).astype(jnp.uint32)
    hd_n = jnp.where(dyn, 14, 0)

    oi = jnp.arange(NCL, dtype=jnp.int32)[None, :]
    clv = plan["cl_len_ord"].astype(jnp.uint32)                  # [NB, 19]
    cln = jnp.where(dyn[:, None] & (oi < plan["ncl"][:, None]), 3, 0)

    # CL token slots: rev(cl_code[sym]) | extra_val << cl_len[sym].
    cl_code_at = jnp.sum(
        ((plan["cl_sym"][:, :, None] == jnp.arange(NCL)[None, None, :])
         & plan["cl_emit"][:, :, None]) * plan["cl_code"][:, None, :], axis=2)
    rev = bit_reverse(cl_code_at, plan["cl_len_at"], MAX_CL_BITS)
    tok_val = (rev | (plan["cl_ev"] << plan["cl_len_at"])).astype(jnp.uint32)
    tok_n = jnp.where(dyn[:, None] & plan["cl_emit"],
                      plan["cl_len_at"] + plan["cl_eb"], 0)

    # Offsets: dynamic-header slots are sequential from start+3.
    dyn_n = jnp.concatenate([hd_n[:, None], cln, tok_n], axis=1)  # [NB,1+19+J]
    dyn_excl = jnp.cumsum(dyn_n, axis=1) - dyn_n
    dyn_off = start[:, None] + 3 + dyn_excl
    dyn_val = jnp.concatenate([hd_val[:, None], clv, tok_val], axis=1)

    vals = jnp.concatenate(
        [s0_val[:, None], sA_val[:, None], sB_val[:, None], sC_val[:, None],
         dyn_val], axis=1)
    nbits = jnp.concatenate(
        [s0_n[:, None], sA_n[:, None], sB_n[:, None], sC_n[:, None], dyn_n],
        axis=1)
    offs = jnp.concatenate(
        [s0_off[:, None], sA_off[:, None], sB_off[:, None], sC_off[:, None],
         dyn_off], axis=1)
    nbits = jnp.where(live[:, None], nbits, 0)
    return vals, nbits, offs


def body_tables(plan: dict, btype: jax.Array, tables: dict | None = None):
    """Final per-block stage2 tables: packed (bit-reversed code) |
    (len << 16) for litlen [NB,288] and dist [NB,30]; EOB code/len [NB].
    Fixed blocks use the RFC fixed code; stored blocks zero."""
    if tables is None:
        tables = plan_tables()
    fixed_ll = jnp.asarray(tables["fixed_ll"], jnp.int32)
    fixed_dl = jnp.asarray(tables["fixed_dl"], jnp.int32)
    fixed_lc = jnp.asarray(tables["fixed_lc"], jnp.int32)
    fixed_dc = jnp.asarray(tables["fixed_dc"], jnp.int32)

    dynb = (btype == 2)[:, None]
    fixb = (btype == 1)[:, None]
    ll = jnp.where(dynb, plan["lit_len"],
                   jnp.where(fixb, fixed_ll[None, :], 0))
    lc = jnp.where(dynb, plan["lit_code"],
                   jnp.where(fixb, fixed_lc[None, :], 0))
    dl = jnp.where(dynb, plan["dist_len"],
                   jnp.where(fixb, fixed_dl[None, :], 0))
    dc = jnp.where(dynb, plan["dist_code"],
                   jnp.where(fixb, fixed_dc[None, :], 0))
    lrev = bit_reverse(lc, ll, MAX_BITS)
    drev = bit_reverse(dc, dl, MAX_BITS)
    lit_cl = (lrev | (ll << 16)).astype(jnp.int32)
    dist_cl = (drev | (dl << 16)).astype(jnp.int32)
    eob_val = lrev[:, 256].astype(jnp.uint32)
    eob_n = ll[:, 256]
    return lit_cl, dist_cl, eob_val, eob_n


def plan_device(lit_hist: jax.Array, dist_hist: jax.Array,
                block_len: jax.Array, buf_start: jax.Array,
                bfinal: jax.Array, tables: dict | None = None,
                live=None):
    """Full device plan: histograms -> everything stage2 needs.

    live [NB] bool: False marks padding blocks (sharded layouts) that
    must contribute zero output bits. Returns dict: btype, body_off,
    chunk1_off, end_pos, lit_cl, dist_cl, eob_val, eob_n, header
    (vals, nbits, offs)."""
    if tables is None:
        tables = plan_tables()
    block_len = jnp.asarray(block_len, jnp.int32)
    buf_start = jnp.asarray(buf_start, bool)
    bfinal = jnp.asarray(bfinal, bool)
    plan = plan_from_freqs(lit_hist, dist_hist, tables)
    sched = choose_btypes(
        plan["dyn_header_bits"] + plan["dyn_body_bits"],
        plan["fixed_body_bits"], block_len, buf_start,
        plan["dyn_header_bits"], live)
    hv, hn, ho = header_slots(plan, sched, block_len, bfinal, live)
    lit_cl, dist_cl, eob_val, eob_n = body_tables(plan, sched["btype"],
                                                  tables)
    return {
        "btype": sched["btype"], "body_off": sched["body_off"],
        "chunk1_off": sched["chunk1_off"], "end_pos": sched["end_pos"],
        "lit_cl": lit_cl, "dist_cl": dist_cl,
        "eob_val": eob_val, "eob_n": eob_n,
        "hdr_vals": hv, "hdr_nbits": hn, "hdr_offs": ho,
    }
