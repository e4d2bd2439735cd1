"""Device mesh + sharded encode step (SURVEY.md §2.2/§2.3).

The reference crate is strictly single-threaded; every parallel structure
here is new. Primary strategy: data-parallel over independent DEFLATE
blocks (`dp` axis), with the 32 KiB window halo passed between neighboring
shards (the sequence-parallel analogue of ring-attention halo exchange) and
an ordered gather of per-shard compressed sizes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpz import device


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    device.platform()  # configures the compile cache before any compile
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def halo_rows(base: jax.Array, window: int, fwd: int,
              first_halo: jax.Array | None = None) -> jax.Array:
    """[NB, block] rows -> [NB, window+block+fwd] haloed rows: each row
    gets the previous row's tail as its window halo (row 0: zeros or
    `first_halo` [1, window], e.g. a ppermute-received shard boundary)
    and the next row's head as forward pad. The byte-level layout twin
    of deflate_pipeline._make_words (which builds u32 word rows from a
    1-D span)."""
    block = base.shape[1]
    prev_tail = jnp.concatenate(
        [jnp.zeros((1, window), base.dtype), base[:-1, block - window:]],
        axis=0)
    if first_halo is not None:
        prev_tail = prev_tail.at[0:1].set(first_halo)
    next_head = jnp.concatenate(
        [base[1:, :fwd], jnp.zeros((1, fwd), base.dtype)], axis=0)
    return jnp.concatenate([prev_tail, base, next_head], axis=1)


def sharded_encode_step(mesh: Mesh, k: int = 4, window: int = 512,
                        block: int = 1024):
    """Builds the jitted sharded one-step encode: blocks sharded over `dp`,
    per-device match-find + parse + histogram, halo via ppermute, ordered
    all_gather of per-block token counts/histograms (the variable-length
    gather pattern's fixed-size prologue; SURVEY.md §2.3 item 3).

    Sizes are parameters so the dry-run can use tiny shapes; the real
    pipeline uses window=32768, block=65536.
    """
    from tpz.kernels.matchfinder import find_matches
    from tpz.kernels.parse import greedy_parse

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    fwd = 512

    def per_shard(base, span_off, span_len):
        # base: [NBl, block] local blocks (already windowed layout without
        # halos). Halo exchange: each shard needs the last `window` bytes of
        # the previous shard's last block, delivered by ppermute; shard 0's
        # halo is zeros (span start). Row layout then comes from the shared
        # halo_rows helper (the byte-level twin of _make_words' word rows —
        # the production sharded path, sharded_compress, reuses
        # _fused_encode_fn directly and needs no halo logic at all).
        last_tail = base[-1:, block - window:]
        recv = jax.lax.ppermute(
            last_tail, axis, [(i, (i + 1) % ndev) for i in range(ndev)])
        first_halo = jnp.where(
            (jax.lax.axis_index(axis) == 0)[None, None], 0, recv)
        haloed = halo_rows(base, window, fwd, first_halo).astype(jnp.int32)
        mlen, mdist = find_matches(haloed, span_off, span_len, k=k,
                                   window=window, block=block)
        block_len = jnp.minimum(
            jnp.maximum(span_len - span_off, 0), block)
        is_token, token_idx, ntokens = greedy_parse(mlen, mdist, block_len)
        # Ordered fixed-size gather of per-block token counts — the
        # metadata prologue of the ordered ragged all-gather.
        all_counts = jax.lax.all_gather(ntokens, axis, tiled=True)
        return mlen, mdist, is_token, all_counts

    @functools.partial(jax.jit)
    def step(blocks, span_off, span_len):
        from jax import shard_map

        sharded = shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis), P()),
            out_specs=(P(axis, None), P(axis, None), P(axis, None), P()),
            check_vma=False,
        )
        return sharded(blocks, span_off, span_len)

    return step


def sharded_compress(data: bytes, mesh: Mesh, k: int = 32,
                     level: int = 6) -> bytes:
    """End-to-end device-sharded gzip encode (SURVEY.md §2.2 DP row,
    §2.3 pattern 3; VERDICT r1 #5).

    The input is split into per-device spans (whole 64 KiB blocks per
    shard; the format-sanctioned DP unit is an independent gzip member
    per shard, window reset at the cut). ONE jit does everything on the
    mesh: each shard runs the fused encode (same _make_words/_stage1/
    plan_device/bitpack code as the single-device path — no duplicated
    halo logic), then the ordered ragged all-gather assembles the raw
    member streams in stream order. The host only wraps gzip framing
    around the gathered members.

    Byte-identity: each member's deflate stream equals
    deflate.compress(span) for the same span (tested on the 8-device CPU
    mesh in tests/test_parallel.py)."""
    import struct

    from jax import shard_map

    from tpz import oracle
    from tpz.codecs.gzip_codec import header_bytes
    from tpz.kernels import deflate_pipeline as dp
    from tpz.kernels.deflate_plan_device import plan_tables
    from tpz.kernels.matchfinder import BLOCK, FWD_PAD, WINDOW

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    n = len(data)
    from tpz.codecs.deflate import DeflateConfig

    cfg = DeflateConfig(level=level)
    if n == 0:
        from tpz.codecs import gzip_codec

        return gzip_codec.compress(b"")
    nb_total = (n + BLOCK - 1) // BLOCK
    nb_per = (nb_total + ndev - 1) // ndev
    shard_bytes = nb_per * BLOCK

    # Host layout: per-shard spans with leading zero window + forward pad.
    span_rows = np.zeros((ndev, WINDOW + shard_bytes + FWD_PAD), np.uint8)
    spans = []
    for d in range(ndev):
        lo = d * shard_bytes
        hi = min(n, lo + shard_bytes)
        chunk = data[lo:hi] if lo < n else b""
        spans.append(chunk)
        if chunk:
            span_rows[d, WINDOW:WINDOW + len(chunk)] = np.frombuffer(
                chunk, np.uint8)
    lens = np.array([len(s) for s in spans], np.int64)
    span_off = np.broadcast_to(
        (np.arange(nb_per) * BLOCK).astype(np.int32),
        (ndev, nb_per)).copy()
    span_len = np.repeat(lens.astype(np.int32)[:, None], nb_per, axis=1)
    block_len = np.maximum(
        np.minimum(lens[:, None] - np.arange(nb_per)[None, :] * BLOCK,
                   BLOCK), 0).astype(np.int32)
    buf_start = np.zeros((ndev, nb_per), bool)
    buf_start[:, 0] = True
    bfinal = np.zeros((ndev, nb_per), bool)
    last_live = np.maximum((lens + BLOCK - 1) // BLOCK - 1, 0)
    bfinal[np.arange(ndev), last_live] = True

    cap_words = (9 * shard_bytes + 31) // 32 + 3 * nb_per + 16
    cap_bytes = 4 * cap_words  # _fused_encode_fn returns [cap_words] u32
    tables = {kk: jnp.asarray(v) for kk, v in plan_tables().items()}

    def per_shard(span_row, so, sl, bl, bs, bf, tabs):
        out_buf = jnp.zeros((cap_words + 2,), jnp.uint32)
        words, end_pos = dp._fused_encode_fn(
            span_row[0], so[0], sl[0], bl[0], bs[0], bf[0], out_buf, tabs,
            **dp.cfg_statics(cfg))
        size = (end_pos[-1] + 7) // 8  # stream bytes (0 for empty shards)
        # words -> little-endian bytes (explicit, not bitcast: XLA's byte
        # order for narrowing bitcasts is implementation-defined).
        by = jnp.stack([(words >> (8 * i)) & jnp.uint32(0xFF)
                        for i in range(4)], axis=1).reshape(-1)
        by = by[:cap_bytes].astype(jnp.uint8)
        # Ordered ragged all-gather (SURVEY.md §2.3 pattern 3).
        all_sizes = jax.lax.all_gather(size[None], axis, tiled=True)  # [ndev]
        offsets = jnp.cumsum(all_sizes) - all_sizes
        all_pay = jax.lax.all_gather(by[None, :], axis, tiled=True)
        total_cap = ndev * cap_bytes
        col = jax.lax.broadcasted_iota(jnp.int32, (ndev, cap_bytes), 1)
        dst = offsets[:, None] + col
        live = col < all_sizes[:, None]
        dst = jnp.where(live, dst, total_cap)
        gathered = jnp.zeros((total_cap + 1,), jnp.uint8).at[
            dst.reshape(-1)].add(
                jnp.where(live, all_pay, 0).reshape(-1), mode="drop")
        return gathered[:total_cap][None], all_sizes[None]

    step = jax.jit(shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None)),
        check_vma=False,
    ))
    gathered, all_sizes = step(
        jnp.asarray(span_rows), jnp.asarray(span_off),
        jnp.asarray(span_len), jnp.asarray(block_len),
        jnp.asarray(buf_start), jnp.asarray(bfinal), tables)
    # Every row is the same replicated result; take row 0.
    sizes = np.asarray(all_sizes)[0]
    blob = np.asarray(gathered)[0]

    # Host gzip framing: one member per non-empty shard.
    out = bytearray()
    hdr = header_bytes(level)
    off = 0
    for d in range(ndev):
        sz = int(sizes[d])
        if sz == 0:
            continue
        body = blob[off:off + sz].tobytes()
        off += sz
        crc = (oracle.crc32_reflected(spans[d]) ^ 0xFFFFFFFF)
        out += hdr + body + struct.pack("<II", crc, len(spans[d]) & 0xFFFFFFFF)
    return bytes(out)


def sharded_compress_bzip2(data: bytes, mesh: Mesh,
                           level: int = 9) -> bytes:
    """End-to-end device-sharded bzip2 encode (SURVEY.md §2.2 DP row;
    VERDICT r2 next #6). bzip2 is the format DESIGNED for DP: 100k-900k
    post-RLE1 blocks are fully independent — no window halo at all.

    Layout: host RLE1 splits the input into blocks; contiguous block
    ranges shard over `dp`; ONE jit runs the ALL-device encode (BWT +
    MTF + RLE2 + multi-table Huffman coder + MSB bitpack — the same
    _fused_full_fn as the single-device path) per shard and assembles
    the per-shard payloads with the ordered ragged all-gather.

    Round 4 (VERDICT r3 item 8): the output is ONE STREAM PER BLOCK —
    the host writes each block's 4-byte 'BZh' header and EOS trailer,
    and the streams concatenate as a standard multi-stream .bz2 (what
    `bzip2` itself produces for concatenated files). Because a block's
    stream bytes depend only on the block's content, the output is
    byte-identical across EVERY mesh size — mesh(N) == mesh(1) is the
    tested invariant — at +14 bytes per 900 KB block."""
    from jax import shard_map

    from tpz import oracle
    from tpz.kernels.bzip2_pipeline import (_bucket, _fused_full_fn,
                                            _splice_eos)

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    if len(data) == 0:
        return oracle.bzip2_encode(b"", level)
    rle, off, ln, crc = oracle.bzip2_rle1(data, level)
    nb = off.size
    bpd = -(-nb // ndev)
    N = _bucket(int(ln.max()))
    rounds = max(1, (N - 1).bit_length())
    blocks = np.zeros((ndev, bpd, N), np.uint8)
    lens = np.zeros((ndev, bpd), np.int32)
    crcs = np.zeros((ndev, bpd), np.uint32)
    # Dummy 1-byte blocks keep padded rows valid; host drops their output.
    blocks[:, :, 0] = 65
    lens[:, :] = 1
    for b in range(nb):
        d, j = divmod(b, bpd)
        blocks[d, j, : ln[b]] = rle[off[b] : off[b] + ln[b]]
        lens[d, j] = ln[b]
        crcs[d, j] = crc[b]
    # Every block starts its own stream (word-aligned, 32-bit header gap)
    # => per-block bytes are mesh-size-invariant.
    buf_start = np.ones((ndev, bpd), bool)
    live = np.zeros((ndev, bpd), bool)
    for b in range(nb):
        d, j = divmod(b, bpd)
        live[d, j] = True
    cap_words = (17 * bpd * (N + 1) + bpd * 60000 + 31) // 32 + 16
    cap_words = (cap_words + (1 << 15) - 1) >> 15 << 15
    cap_bytes = 4 * cap_words

    def per_shard(blk, n_, crc_, bs, lv):
        words, body_off, end_bits = _fused_full_fn(
            blk[0], n_[0], crc_[0], bs[0], rounds=rounds,
            cap_words=cap_words, live=lv[0])
        end_last = end_bits[-1]
        size = (end_last + 7) // 8
        # Big-endian bytes (bzip2 packs MSB-first u32 words).
        by = jnp.stack([(words >> (8 * (3 - i))).astype(jnp.uint32)
                        & jnp.uint32(0xFF)
                        for i in range(4)], axis=1).reshape(-1)
        by = by[:cap_bytes].astype(jnp.uint8)
        all_sizes = jax.lax.all_gather(size[None], axis, tiled=True)
        all_boff = jax.lax.all_gather(body_off[None, :], axis, tiled=True)
        all_ends = jax.lax.all_gather(end_bits[None, :], axis, tiled=True)
        offsets = jnp.cumsum(all_sizes) - all_sizes
        all_pay = jax.lax.all_gather(by[None, :], axis, tiled=True)
        total_cap = ndev * cap_bytes
        col = jax.lax.broadcasted_iota(jnp.int32, (ndev, cap_bytes), 1)
        dst = offsets[:, None] + col
        live = col < all_sizes[:, None]
        dst = jnp.where(live, dst, total_cap)
        gathered = jnp.zeros((total_cap + 1,), jnp.uint8).at[
            dst.reshape(-1)].add(
                jnp.where(live, all_pay, 0).reshape(-1), mode="drop")
        return (gathered[:total_cap][None], all_sizes[None],
                all_boff[None], all_ends[None])

    step = jax.jit(shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None),
                   P(axis, None)),
        check_vma=False,
    ))
    from tpz.kernels.bwt import cyclic_words

    wcyc = cyclic_words(blocks.reshape(ndev * bpd, N),
                        lens.reshape(-1)).reshape(ndev, bpd, N)
    gathered, all_sizes, all_boff, all_ends = step(
        jnp.asarray(wcyc), jnp.asarray(lens), jnp.asarray(crcs),
        jnp.asarray(buf_start), jnp.asarray(live))
    sizes = np.asarray(all_sizes)[0]
    boffs = np.asarray(all_boff)[0]
    ends = np.asarray(all_ends)[0]
    blob = np.asarray(gathered)[0]

    hdr = b"BZh" + bytes([0x30 + max(1, min(9, level))])
    out = bytearray()
    pos = 0
    for d in range(ndev):
        sz = int(sizes[d])
        lo, hi = d * bpd, min((d + 1) * bpd, nb)
        for b in range(lo, hi):
            j = b - lo
            start_bit = int(boffs[d, j]) - 32  # word-aligned header gap
            end_bit = int(ends[d, j])
            buf = bytearray(
                blob[pos + start_bit // 8: pos + (end_bit + 7) // 8]
                .tobytes())
            buf[0:4] = hdr
            out += _splice_eos(buf, end_bit - start_bit, [int(crc[b])])
        pos += sz
    return bytes(out)


def ragged_all_gather(mesh: Mesh, payload_pad: jax.Array,
                      sizes: jax.Array):
    """Ordered variable-length gather (SURVEY.md §2.3 pattern 3).

    payload_pad: [n_dev, CAP] uint8 — each device's ragged payload, padded;
    sizes: [n_dev] int32 actual lengths. Under shard_map: all_gather the
    small size vector, prefix-sum offsets, all_gather the padded payloads,
    then every device materializes the in-order concatenation.
    Returns (gathered [n_dev*CAP] uint8 concatenated by offset, total int32).
    """
    from jax import shard_map

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    cap = payload_pad.shape[-1]

    def body(pay, sz):
        all_sizes = jax.lax.all_gather(sz, axis, tiled=True)      # [ndev]
        offsets = jnp.cumsum(all_sizes) - all_sizes               # excl scan
        all_pay = jax.lax.all_gather(pay, axis, tiled=True)       # [ndev,CAP]
        total_cap = ndev * cap
        out = jnp.zeros((total_cap,), jnp.uint8)
        # Scatter each device's payload to its stream offset.
        col = jax.lax.broadcasted_iota(jnp.int32, (ndev, cap), 1)
        dev = jax.lax.broadcasted_iota(jnp.int32, (ndev, cap), 0)
        dst = offsets[:, None] + col
        live = col < all_sizes[:, None]
        dst = jnp.where(live, dst, total_cap)  # park padding
        out = jnp.zeros((total_cap + 1,), jnp.uint8).at[
            dst.reshape(-1)].add(jnp.where(live, all_pay, 0).reshape(-1),
                                 mode="drop")
        del dev
        return out[:total_cap], jnp.sum(all_sizes)

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    ))(payload_pad, sizes)


def ring_all_gather(mesh: Mesh, payload_pad: jax.Array,
                    sizes: jax.Array):
    """Ring-scheduled ordered ragged all-gather (SURVEY.md §2.2
    ring/blockwise row; the round-1 gap flagged by VERDICT §2.2).

    Same contract and output as ragged_all_gather, but payloads move in
    n_dev - 1 `ppermute` hops around the ring instead of one global
    all_gather: every round each ICI link carries exactly one shard's
    padded payload, which is the bandwidth-optimal schedule at pod scale
    (a global all-gather of the concatenated payloads would congest the
    shared links; the tiny size vector still uses all_gather). Each
    device accumulates the chunk it currently holds into the in-order
    output, so after n_dev rounds every device has materialized the full
    ordered stream.
    """
    from jax import shard_map

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    cap = payload_pad.shape[-1]
    total_cap = ndev * cap

    def body(pay, sz):
        idx = jax.lax.axis_index(axis)
        all_sizes = jax.lax.all_gather(sz, axis, tiled=True)       # [ndev]
        offsets = jnp.cumsum(all_sizes) - all_sizes
        col = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
        out = jnp.zeros((total_cap + 1,), jnp.uint8)
        perm = [(i, (i + 1) % ndev) for i in range(ndev)]
        cur = pay.reshape(cap)
        for r in range(ndev):
            owner = (idx - r) % ndev   # whose chunk this device holds now
            dst = offsets[owner] + col
            live = col < all_sizes[owner]
            out = out.at[jnp.where(live, dst, total_cap)].add(
                jnp.where(live, cur, 0), mode="drop")
            if r < ndev - 1:
                cur = jax.lax.ppermute(cur, axis, perm)
        return out[:total_cap], jnp.sum(all_sizes)

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    ))(payload_pad, sizes)
