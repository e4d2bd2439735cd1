"""Device BZip2 pipeline, both directions (SURVEY.md §2.1 BZip2 row, §7 PR4).

ENCODE (round 3, all-device): host C++ RLE1 + block split (byte-serial,
memory-speed) -> ONE device program running batched BWT + used-map +
MTF + RLE2 + the multi-table Huffman coder + MSB bitpack
(tpz/kernels/bwt.py, mtf.py, rle.py, bzip2_plan_device.py,
bitpack.py) -> host writes only the 4-byte 'BZh' header and the EOS
trailer. Byte-identical to the oracle's Bzip2Encode (the coder mirrors
cpp/bzip2.cc EncodeBlockFromMtf decision-for-decision).

DECODE (round 3, all-device): host header-only scan (magic splitter +
selectors/tables, cpp Bzip2ScanHeaders) -> ONE device program running
the multi-table symbol walk + MTF^-1 + RLE2^-1 (bzip2_walk.py) + run
expansion + the iBWT (ibwt_walk.py) -> host RLE1^-1 +
per-block CRCs + per-stream EOS combined-CRC checks. Shapes the walks
decline (code lengths > 17, periodic blocks, corrupt streams) go to the
host decoder and are counted in tpz.device.declines.

Blocks are padded to a power-of-two bucket so jit caches stay small.
"""

from __future__ import annotations

import functools

import numpy as np


def _bucket(n: int) -> int:
    b = 1 << max(13, (n - 1).bit_length())
    return b


def compress(data: bytes, level: int = 9) -> bytes:
    return compress_many([data], level)[0]


def _fused_full_fn(d_pad, n, crc, buf_start, rounds: int, cap_words: int,
                   live=None):
    """The WHOLE bzip2 encode as ONE device program (round 3; closes the
    SURVEY §2.1 BZip2 row): BWT + used-map + MTF + RLE2 + multi-table
    Huffman coder + MSB bitpack. Only framing (the 4-byte 'BZh<level>'
    stream header and the EOS trailer + combined CRC) stays on host —
    and the d2h shrinks from the ~4 B/input-byte symbol stream to the
    compressed bytes themselves."""
    import jax.numpy as jnp

    from tpz.kernels.bzip2_plan_device import encode_blocks

    orig, syms, sym_len, used, n_used = _fused_bwt_mtf_fn(d_pad, n, rounds)
    from tpz.kernels.bitpack import assemble_stream_msb

    vals, nbits, total_bits = encode_blocks(
        syms, sym_len, used, n_used, orig, crc)
    if live is not None:
        # Mesh padding rows (sharded_compress_bzip2): dead blocks emit
        # zero bits so they never reach the assembled stream.
        nbits = jnp.where(live[:, None], nbits, 0)
        total_bits = jnp.where(live, total_bits, 0)
    # Per-buffer stream layout: each buffer starts word-aligned with a
    # 32-bit gap for the host-written 'BZh<level>' header; blocks inside
    # a buffer are bit-concatenated.
    def step(pos, x):
        tb, bs = x
        pos = jnp.where(bs, (pos + 31) // 32 * 32 + 32, pos)
        return pos + tb, pos

    import jax as _jax

    _, body_off = _jax.lax.scan(step, jnp.int32(0), (total_bits, buf_start))
    words = assemble_stream_msb(vals, nbits, body_off, cap_words)
    return words, body_off, body_off + total_bits


def _fused_bwt_mtf_fn(d_pad, n, rounds: int):
    """BWT + used-map + MTF + RLE2 (the front half of _fused_full_fn)."""
    import jax
    import jax.numpy as jnp

    from tpz.kernels.bwt import _bwt_batched
    from tpz.kernels.mtf import mtf_ranks
    from tpz.kernels.rle import rle2_encode

    last, orig = _bwt_batched(d_pad, n, rounds)
    NB, N = d_pad.shape
    last32 = last.astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, N), 1)
    live = idx < n[:, None]
    lastm = jnp.where(live, last32, 0)
    bidx = jax.lax.broadcasted_iota(jnp.int32, (NB, N), 0)
    used = jnp.zeros((NB, 256), jnp.int32).at[bidx, lastm].max(
        live.astype(jnp.int32), mode="drop")
    to_seq = jnp.cumsum(used, axis=1) - 1
    v = jnp.take_along_axis(to_seq, lastm, axis=1)
    ranks = mtf_ranks(jnp.where(live, v, 0), n)
    syms, sym_len = rle2_encode(ranks, n)
    n_used = jnp.sum(used, axis=1)
    return orig, syms, sym_len, used, n_used


_fused_bwt_mtf = None


def bwt_mtf_rle2_blocks(blocks: np.ndarray, lengths: np.ndarray):
    """blocks: [NB, N] uint8 zero-padded; lengths [NB]. Returns numpy
    (orig, syms, sym_len, used, n_used) — everything the C++ Huffman
    coder needs, from one device invocation (the BWT last column itself
    stays on device; only the ~symbol-stream-sized outputs transfer)."""
    global _fused_bwt_mtf
    import jax
    import jax.numpy as jnp

    from tpz import device

    if _fused_bwt_mtf is None:
        _fused_bwt_mtf = functools.partial(
            jax.jit, static_argnames=("rounds",))(_fused_bwt_mtf_fn)
    from tpz.kernels.bwt import cyclic_words

    NB, N = blocks.shape
    w = cyclic_words(blocks.astype(np.uint8), lengths)
    n = lengths.astype(np.int32)
    rounds = max(1, (N - 1).bit_length())
    orig, syms, sym_len, used, n_used = _fused_bwt_mtf(
        jnp.asarray(w), jnp.asarray(n), rounds=rounds)
    sym_len_np, used_np, n_used_np, orig_np, syms_np = device.fetch_many(
        sym_len, used, n_used, orig, syms)
    return orig_np, syms_np, sym_len_np, used_np, n_used_np


_fused_full = None


def _splice_eos(body: bytearray, end_bit: int, crcs) -> bytes:
    """Append the 48-bit EOS magic + 32-bit combined CRC at `end_bit`
    (blocks are not byte-aligned) and pad to a byte."""
    combined = 0
    for c in crcs:
        combined = (((combined << 1) | (combined >> 31)) ^ int(c)) \
            & 0xFFFFFFFF
    tail_bits = (0x177245385090 << 32) | combined          # 80 bits
    sh = end_bit & 7
    nbytes = (sh + 80 + 7) // 8
    # big int holding the existing partial byte's high bits + the trailer
    head = body[end_bit // 8] >> (8 - sh) if sh else 0
    v = (head << 80) | tail_bits
    v <<= 8 * nbytes - sh - 80
    chunk = v.to_bytes(nbytes, "big")
    del body[end_bit // 8:]
    body += chunk
    return bytes(body)


def compress_many(datas, level: int = 9) -> list[bytes]:
    """Batched bzip2 encode, ALL-device (VERDICT r2 missing #1): every
    buffer's 900k blocks share ONE device program running BWT + MTF +
    RLE2 + the multi-table Huffman coder + MSB bitpack; the host writes
    only the per-stream 'BZh<level>' header and EOS trailer. Byte-
    identical to oracle.bzip2_encode (the coder mirrors
    cpp/bzip2.cc EncodeBlockFromMtf decision-for-decision)."""
    import jax
    import jax.numpy as jnp

    from tpz import device, oracle

    global _fused_full
    if _fused_full is None:
        import functools

        _fused_full = functools.partial(
            jax.jit, static_argnames=("rounds", "cap_words"))(_fused_full_fn)

    results = [None] * len(datas)
    metas = []  # (result idx, block lens, crcs, first-block index)
    all_blocks = []
    all_lens = []
    all_crcs = []
    buf_start = []
    for i, d in enumerate(datas):
        if len(d) == 0:
            results[i] = oracle.bzip2_encode(b"", level)
            continue
        rle, off, ln, crc = oracle.bzip2_rle1(d, level)
        metas.append((i, ln, crc, len(all_blocks)))
        for b in range(off.size):
            all_blocks.append(rle[off[b] : off[b] + ln[b]])
            all_lens.append(int(ln[b]))
            all_crcs.append(int(crc[b]))
            buf_start.append(b == 0)
    if not all_blocks:
        return results
    NB = len(all_blocks)
    N = _bucket(max(all_lens))
    blocks = np.zeros((NB, N), dtype=np.uint8)
    for b, blk in enumerate(all_blocks):
        blocks[b, : len(blk)] = blk
    rounds = max(1, (N - 1).bit_length())
    # Worst-case bits: 17/symbol (code-length limit) + headers/tables.
    cap_words = (17 * NB * (N + 1) + NB * 60000 + 31) // 32 + 16
    cap_words = (cap_words + (1 << 18) - 1) >> 18 << 18
    from tpz.kernels.bwt import cyclic_words

    words, body_off, end_bits = _fused_full(
        jnp.asarray(cyclic_words(blocks, np.asarray(all_lens, np.int64))),
        jnp.asarray(np.asarray(all_lens, np.int32)),
        jnp.asarray(np.asarray(all_crcs, np.uint32)),
        jnp.asarray(np.asarray(buf_start, bool)),
        rounds=rounds, cap_words=cap_words)
    body_off_np, end_np = device.fetch_many(body_off, end_bits)
    used_words = (int(end_np[-1]) + 31) // 32
    q = min((used_words + (1 << 16) - 1) >> 16 << 16, cap_words)
    body = device.fetch(words[:q]).astype(">u4").view(np.uint8)

    hdr = b"BZh" + bytes([0x30 + max(1, min(9, level))])
    for i, ln, crc, b0 in metas:
        nb = ln.size
        start_bit = int(body_off_np[b0]) - 32      # word-aligned
        end_bit = int(end_np[b0 + nb - 1])
        buf = bytearray(body[start_bit // 8 : (end_bit + 7) // 8].tobytes())
        buf[0:4] = hdr                              # 32-bit gap reserved
        results[i] = _splice_eos(buf, end_bit - start_bit, crc)
    return results


def _max_level(data: bytes) -> int:
    """Max stream level across a (possibly concatenated) .bz2 buffer.

    Byte 3 of the FIRST header alone under-sizes the record/output caps
    when a later concatenated stream uses a higher level (ADVICE r3 #2
    — the device path silently declined valid input). Stream headers
    are byte-aligned ('BZh' + level + 48-bit block magic), so scanning
    for that 10-byte pattern finds every one; a false positive can only
    ever GROW the cap (still correct, one bucket larger)."""
    lvl = max(1, min(9, data[3] - 0x30))
    pos = 0
    while True:
        pos = data.find(b"BZh", pos + 1)
        if pos < 0 or pos + 10 > len(data):
            return lvl
        l2 = data[pos + 3] - 0x30
        if 1 <= l2 <= 9 and data[pos + 4:pos + 10] == b"\x31\x41\x59\x26\x53\x59":
            lvl = max(lvl, l2)


def decompress_walk_many(datas) -> list:
    """Batch decode: ALL streams' blocks share ONE fused device program
    (walk + expand + iBWT) when their level buckets match — the decode
    side of the compress_many serving shape. Entries come back None
    where the walk declines (caller falls back per stream)."""
    from tpz import device, oracle
    from tpz.errors import DataError
    from tpz.kernels import bzip2_walk

    results = [None] * len(datas)
    scans = []
    for i, data in enumerate(datas):
        if len(data) < 4:
            scans.append(None)
            continue
        s = oracle.bzip2_scan_headers(data)
        if s is None:
            device.decline("bzip2_scan")
        scans.append(s if s is not None and len(s["sym_bits"]) else None)
    # Group by bucket so one jit shape covers the batch.
    groups = {}
    levels = {}
    for i, s in enumerate(scans):
        if s is None:
            continue
        levels[i] = _max_level(datas[i])
        N = _bucket(bzip2_walk.rec_cap_for(levels[i]))
        groups.setdefault(N, []).append(i)
    for N, idxs in groups.items():
        scap = N + 8192
        cat = {k: np.concatenate([scans[i][k] for i in idxs])
               for k in ("sym_bits", "end_bits", "origs", "crcs",
                         "n_useds", "nts", "nsels")}
        cat["mtf_init"] = np.concatenate(
            [scans[i]["mtf_init"] for i in idxs])
        cat["selectors"] = np.concatenate(
            [scans[i]["selectors"] for i in idxs])
        cat["lens"] = np.concatenate([scans[i]["lens"] for i in idxs])
        counts = [len(scans[i]["sym_bits"]) for i in idxs]
        nb = sum(counts)
        slices = np.zeros((nb, scap), np.uint8)
        ok_group = True
        b0 = 0
        for i, cnt in zip(idxs, counts):
            s = scans[i]
            sb = np.frombuffer(datas[i], np.uint8)
            spans = ((s["end_bits"] + 7) // 8 + 1
                     - s["sym_bits"] // 8).astype(np.int64)
            if int(spans.max()) > scap:
                ok_group = False
                device.decline("bzip2_slice")
                break
            for b in range(cnt):
                s0 = int(s["sym_bits"][b]) // 8
                take = min(int(spans[b]), len(datas[i]) - s0)
                slices[b0 + b, :take] = sb[s0:s0 + take]
            b0 += cnt
        if not ok_group:
            continue
        rec_cap = bzip2_walk.rec_cap_for(max(levels[i] for i in idxs))
        plain, lens, err, endbits, _ = bzip2_walk.decode_blocks_device(
            cat, slices, N, rec_cap=rec_cap)
        b0 = 0
        for i, cnt in zip(idxs, counts):
            s = scans[i]
            sl = slice(b0, b0 + cnt)
            b0 += cnt
            if int(err[sl].sum()) != 0:
                device.decline("bzip2_walk")
                continue
            abs_ends = ((s["sym_bits"] // 8) * 8
                        + endbits[sl].astype(np.int64))
            if not _eos_ok(datas[i], abs_ends, s["crcs"]):
                device.decline("bzip2_eos")
                continue
            lens_i = lens[sl]
            flat = np.zeros(int(lens_i.sum()), np.uint8)
            offs2 = np.zeros(cnt, np.int64)
            pos = 0
            for b in range(cnt):
                offs2[b] = pos
                flat[pos:pos + lens_i[b]] = plain[b0 - cnt + b,
                                                  :lens_i[b]]
                pos += int(lens_i[b])
            try:
                results[i] = oracle.bzip2_rle1_inverse(
                    flat, offs2, lens_i.astype(np.int64), s["crcs"])
            except DataError:
                device.decline("bzip2_crc")
    return results


def _peek_bits(data: bytes, bit: int, n: int) -> int | None:
    b0 = bit // 8
    need = (bit % 8 + n + 7) // 8
    chunk = data[b0:b0 + need]
    if len(chunk) < need:
        return None
    v = int.from_bytes(chunk, "big")
    return (v >> (8 * need - (bit % 8) - n)) & ((1 << n) - 1)


def _eos_ok(data: bytes, end_bits_abs, crcs) -> bool:
    """Multi-stream-aware EOS validation (ADVICE r2 medium parity, round
    3 extension): after EVERY block, the next 48 bits must be the block
    magic (stream continues) or the EOS magic followed by the running
    combined CRC (stream ends, fold resets; the last block must end a
    stream). Handles concatenated .bz2 — including our own sharded
    encoder's output — exactly like the host decoders."""
    combined = 0
    for i, e in enumerate(end_bits_abs):
        combined = (((combined << 1) | (combined >> 31))
                    ^ int(crcs[i])) & 0xFFFFFFFF
        nxt = _peek_bits(data, int(e), 48)
        if nxt == 0x177245385090:                      # EOS
            expect = _peek_bits(data, int(e) + 48, 32)
            if expect != combined:
                return False
            combined = 0
        elif nxt != 0x314159265359:                    # next block magic
            return False
    return combined == 0  # the final block closed its stream


def decompress_walk(data: bytes) -> bytes | None:
    """ALL-device decode (round 3; closes VERDICT r2 missing #1's decode
    half): host parses only block HEADERS (magic splitter + selector/
    table sections, cpp Bzip2ScanHeaders); ONE device program then runs
    the multi-table Huffman symbol walk + MTF^-1 + RLE2^-1
    (tpz/kernels/bzip2_walk.py) -> run expansion -> iBWT ->
    plaintext rows. Host finishes with RLE1^-1 + per-block CRCs (C++)
    and the EOS combined-CRC check. Returns None on shapes the walk
    declines — caller falls back."""
    from tpz import oracle
    from tpz.errors import DataError
    from tpz.kernels import bzip2_walk

    scan = oracle.bzip2_scan_headers(data)
    if scan is None:
        return None
    nb = len(scan["sym_bits"])
    if nb == 0:
        return None
    level = _max_level(data)
    N = _bucket(bzip2_walk.rec_cap_for(level))
    scap = N + 8192
    spans = ((scan["end_bits"] + 7) // 8 + 1
             - scan["sym_bits"] // 8).astype(np.int64)
    if int(spans.max()) > scap:
        return None
    sb = np.frombuffer(data, np.uint8)
    slices = np.zeros((nb, scap), np.uint8)
    for b in range(nb):
        s0 = int(scan["sym_bits"][b]) // 8
        take = min(int(spans[b]), len(data) - s0)
        slices[b, :take] = sb[s0:s0 + take]
    plain, lens, err, endbits, ok = bzip2_walk.decode_blocks_device(
        scan, slices, N, rec_cap=bzip2_walk.rec_cap_for(level))
    if not ok:
        return None
    # EOS trailers: every stream's 48-bit magic + 32-bit combined CRC
    # (ADVICE r2 medium parity; multi-stream aware — concatenated .bz2
    # and our own sharded output decode here too).
    abs_ends = (scan["sym_bits"] // 8) * 8 + endbits.astype(np.int64)
    if not _eos_ok(data, abs_ends, scan["crcs"]):
        return None
    flat = np.zeros(int(lens.sum()), np.uint8)
    pos = 0
    offs2 = np.zeros(nb, np.int64)
    for b in range(nb):
        offs2[b] = pos
        flat[pos:pos + lens[b]] = plain[b, :lens[b]]
        pos += int(lens[b])
    try:
        return oracle.bzip2_rle1_inverse(flat, offs2, lens.astype(np.int64),
                                         scan["crcs"])
    except DataError:
        return None


def decompress(data: bytes) -> bytes | None:
    """Device decode. Primary: the ALL-device route (decompress_walk).
    Fallback within the device path: host Huffman/MTF/RLE2 inverse to
    last columns + device iBWT. Returns None when neither supports the
    stream shape — the caller falls back to the serial oracle, which
    handles every shape."""
    from tpz import device, oracle
    from tpz.errors import DataError
    from tpz.kernels.ibwt_walk import ibwt_blocks_fast

    out = decompress_walk(data)
    if out is not None:
        return out
    device.decline("bzip2_walk")
    scan = oracle.bzip2_scan_to_last(data)
    if scan is None:
        return None
    blob, offs, lens, origs, crcs = scan
    nb = len(offs)
    if nb == 0:
        return b""
    N = _bucket(int(lens.max()))
    last = np.zeros((nb, N), np.uint8)
    for b in range(nb):
        last[b, : lens[b]] = blob[offs[b] : offs[b] + lens[b]]
    out_rows = ibwt_blocks_fast(last, lens, origs)
    if out_rows is None:
        device.decline("bzip2_ibwt")
        return None
    flat = np.zeros(int(lens.sum()), np.uint8)
    pos = 0
    offs2 = np.zeros(nb, np.int64)
    for b in range(nb):
        offs2[b] = pos
        flat[pos : pos + lens[b]] = out_rows[b, : lens[b]]
        pos += int(lens[b])
    try:
        return oracle.bzip2_rle1_inverse(flat, offs2, lens, crcs)
    except DataError:
        # A CRC miss here can mean device-path limitation rather than a
        # corrupt stream; the host decoder re-checks and is authoritative.
        return None
