#!/usr/bin/env python
"""Smoke run of every device codec on the GPU, through tpz.api.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded encoders only
    python chip_smoke.py --ab     # one GPU: kernel-vs-XLA and host-vs-device
                                  # A/B timings, encode memory at 2 x 64 MiB

Phases (data from tpz.utils.corpus.mixed with fixed seeds):

  gzip_encode       2 x 16 MiB batched at level 6, one 32 MiB stream at
                    level 9; every member byte-identical to the C++
                    oracle and decoded by stdlib gzip.
  deflate_decode    a 16 MiB TZ-indexed gzip, a 4 x 4 MiB batch, a 16 MiB
                    foreign zlib stream; equal to the input.
  bzip2             level 9 at 16 MiB: encode identical to the oracle and
                    decoded by stdlib bz2; device decode equal to the input.
  lzhuf             lh5 and lh7 at 16 MiB: encode identical to the oracle;
                    device decode equal to the input.
  kernel_*          each Pallas-Triton kernel against its plain reference
                    at the same sizes (exact bytes).

A phase also fails if any device route handed an input to the host
decoder (tpz.device.declines). One line per phase: name, bytes,
compile_s (the first call, compilation included), warm_s (a second call
on fresh data of the same shape), check_s (the oracle and stdlib checks,
timed apart from the calls), declines, ok. Only the call under test is
inside compile_s and warm_s. The last line of standard output is the JSON
verdict: {"ok": true, "device": {"platform": ..., "kind": ..., "count":
...}}. The script exits non-zero, printing no verdict, on any failure or
when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import bz2
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MiB = 1 << 20
GZ_HDR = 10  # tpz's gzip header; the TZ-indexed one is longer


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _phase(name: str, nbytes: int, run, check, inputs) -> list:
    """Call run(x) for each input, timing the call alone: the first is
    compile_s, a second is warm_s. Then check(x, out) must hold for every
    output; the checks are timed apart (check_s). Declines counted during
    the phase fail it. Returns the outputs."""
    from tpz import device

    before = sum(device.declines.values())
    outs, times = [], []
    for x in inputs:
        t0 = time.perf_counter()
        outs.append(run(x))
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ok = all([check(x, out) for x, out in zip(inputs, outs)])
    check_s = time.perf_counter() - t0
    declines = sum(device.declines.values()) - before
    warm = f"{times[1]:.3f}" if len(times) > 1 else "-"
    print(f"phase={name} bytes={nbytes} compile_s={times[0]:.3f} "
          f"warm_s={warm} check_s={check_s:.3f} declines={declines} "
          f"ok={ok and declines == 0}", flush=True)
    if not ok or declines:
        raise SystemExit(f"phase {name} failed "
                         f"(ok={ok}, declines={dict(device.declines)})")
    return outs


def _memory_analysis(tag: str, datas, cfg) -> None:
    """compiled.memory_analysis() of the fused DEFLATE encode. An
    executable loaded from the compile cache reports peak 0; then
    temp + argument + output bytes bound the peak."""
    import jax.numpy as jnp

    from tpz.kernels import deflate_pipeline as dp

    span, so, sl, bl, bs, bf, cap, _ = dp.encode_layout(
        datas, list(range(len(datas))))
    comp = dp._fused_jit.lower(
        *(jnp.asarray(a) for a in (span, so, sl, bl, bs, bf)),
        jnp.zeros((cap + 2,), jnp.uint32), dp.plan_tables_dev(),
        **dp.cfg_statics(cfg)).compile()
    ma = comp.memory_analysis()
    fields = {k: getattr(ma, k) for k in dir(ma) if k.endswith("_in_bytes")}
    fields["temp_argument_output_bytes"] = (
        ma.temp_size_in_bytes + ma.argument_size_in_bytes
        + ma.output_size_in_bytes - ma.alias_size_in_bytes)
    print(f"memory_analysis fused_deflate_encode {tag} "
          + json.dumps(fields, sort_keys=True), flush=True)


def _decode_phase(name: str, nbytes: int, fmt: str, pairs) -> None:
    """pairs: (encoded, plain) for the first and the warm call."""
    from tpz import api

    _phase(name, nbytes,
           lambda p: api.decompress(p[0], fmt, backend="device"),
           lambda p, out: out == p[1], pairs)


def one_device() -> None:
    from tpz import api, device, oracle
    from tpz.codecs.deflate import DeflateConfig
    from tpz.constants import LZHUF_METHODS
    from tpz.kernels import bzip2_pipeline, inflate_pipeline, lzhuf_walk
    from tpz.utils import corpus

    mixed = corpus.mixed

    # ---- gzip encode ----
    def gzip_phase(name, level, inputs):
        params = DeflateConfig(level=level).params_array()

        def check(datas, outs):
            return all(o[GZ_HDR:-8] == oracle.deflate_encode(d, params)
                       and gzip.decompress(o) == d
                       for o, d in zip(outs, datas))

        _phase(name, sum(map(len, inputs[0])),
               lambda datas: api.compress_many(datas, "gzip", level=level,
                                               backend="device"),
               check, inputs)

    batch = [mixed(16 * MiB, seed=1), mixed(16 * MiB, seed=2)]
    gzip_phase("gzip_encode_2x16MiB_l6", 6,
               [batch, [mixed(16 * MiB, seed=3), mixed(16 * MiB, seed=4)]])
    _memory_analysis("2x16MiB", batch, DeflateConfig(level=6))
    gzip_phase("gzip_encode_32MiB_l9", 9,
               [[mixed(32 * MiB, seed=5)], [mixed(32 * MiB, seed=6)]])

    # ---- DEFLATE decode ----
    d16 = [mixed(16 * MiB, seed=7), mixed(16 * MiB, seed=8)]
    tz = [api.compress(d, "gzip", backend="device") for d in d16]
    _decode_phase("deflate_decode_tz_16MiB", 16 * MiB, "gzip",
                  list(zip(tz, d16)))
    b4 = [mixed(4 * MiB, seed=10 + i) for i in range(8)]
    b4c = api.compress_many(b4, "gzip", backend="device")
    _phase("deflate_decode_batch_4x4MiB", 16 * MiB,
           lambda p: api.decompress_many(p[0], "gzip", backend="device"),
           lambda p, out: out == p[1],
           [(b4c[:4], b4[:4]), (b4c[4:], b4[4:])])
    zf = [zlib.compress(d, 6) for d in d16]
    _decode_phase("deflate_decode_foreign_zlib_16MiB", 16 * MiB, "zlib",
                  list(zip(zf, d16)))

    # ---- bzip2 ----
    z16 = [mixed(16 * MiB, seed=20), mixed(16 * MiB, seed=21)]
    bz = _phase("bzip2_encode_16MiB_l9", 16 * MiB,
                lambda d: api.compress(d, "bzip2", level=9,
                                       backend="device"),
                lambda d, out: (out == oracle.bzip2_encode(d, 9)
                                and bz2.decompress(out) == d), z16)
    _decode_phase("bzip2_decode_16MiB_l9", 16 * MiB, "bzip2",
                  list(zip(bz, z16)))

    # ---- LZHUF ----
    lz = {}
    for m in ("lh5", "lh7"):
        bits = LZHUF_METHODS[m][0]
        lz[m] = _phase(
            f"lzhuf_encode_16MiB_{m}", 16 * MiB,
            lambda d, m=m: api.compress(d, m, backend="device"),
            lambda d, out, bits=bits: (
                out[15:] == oracle.lzhuf_encode(d, bits, 16)), z16)
        _decode_phase(f"lzhuf_decode_16MiB_{m}", 16 * MiB, m,
                      list(zip(lz[m], z16)))

    # ---- each Triton kernel against its plain reference ----
    kw = device.walk_mode()  # "triton" on the GPU
    raw = zf[0][2:-4]
    idx = inflate_pipeline.index_stream(raw)
    _phase("kernel_inflate_walk_vs_xla_twin_16MiB", 16 * MiB,
           lambda r: inflate_pipeline.decompress_segmented(r, idx, walk=kw),
           lambda r, out: out == inflate_pipeline.decompress_segmented(
               r, idx, walk="reference"), [raw])
    _phase("kernel_lzhuf_walk_vs_xla_twin_16MiB", 16 * MiB,
           lambda b: lzhuf_walk.decompress(b, len(z16[0]), 13, walk=kw),
           lambda b, out: out == lzhuf_walk.decompress(
               b, len(z16[0]), 13, walk="reference"), [lz["lh5"][0][15:]])
    _phase("kernel_bzip2_walk_vs_host_decoder_16MiB", 16 * MiB,
           bzip2_pipeline.decompress_walk,
           lambda b, out: out == oracle.bzip2_decode(b), [bz[0]])


def _timed(fn, reps: int = 3):
    """(output, first call s, [warm call s, ...])"""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm.append(time.perf_counter() - t0)
    return out, first, warm


def _ab_line(name: str, side: str, first: float, warm, ok: bool) -> bool:
    print(f"ab {name} side={side} first_s={first:.4f} warm_s="
          + ",".join(f"{w:.4f}" for w in warm) + f" ok={ok}", flush=True)
    return ok


def ab() -> None:
    """Each hand-written kernel against the plain version XLA compiles,
    through the same wrapper at 16 MiB, in turns kernel, XLA, XLA,
    kernel; the host C++ decoder of the same stream; host against device
    through tpz.api for every decode; and the fused encode's memory at
    2 x 64 MiB (the bound behind deflate_pipeline.MAX_DEVICE_SPAN)."""
    import numpy as np

    from tpz import api, device, oracle
    from tpz.codecs import gzip_codec
    from tpz.codecs.deflate import DeflateConfig
    from tpz.constants import LZHUF_METHODS
    from tpz.kernels import bzip2_pipeline, inflate_pipeline as ip
    from tpz.kernels import lzhuf_walk
    from tpz.kernels.ibwt_walk import ibwt_blocks_fast
    from tpz.utils import corpus

    kw = device.walk_mode()  # also configures the compile cache
    turns = (kw, "reference", "reference", kw)
    ok = True

    # DEFLATE walk: foreign zlib (segment route) and TZ-indexed gzip.
    data = corpus.mixed(16 * MiB, seed=21)
    raw = zlib.compress(data, 6)[2:-4]
    idx = ip.index_stream(raw)
    tzd = corpus.mixed(16 * MiB, seed=22)
    gz = api.compress(tzd, "gzip", backend="device")
    pos, extra = gzip_codec.parse_header_extra(gz, 0)
    bits, lens = gzip_codec.parse_tz_extra(extra)
    body = gz[pos:pos + (int(bits[-1]) + 7) // 8]
    for w in turns:
        out, f, ws = _timed(lambda: ip.decompress_segmented(raw, idx, walk=w))
        ok &= _ab_line("inflate_walk_foreign_16MiB", w, f, ws, out == data)
        out, f, ws = _timed(lambda: ip.decompress_indexed(body, bits, lens,
                                                          walk=w))
        ok &= _ab_line("inflate_walk_tz_16MiB", w, f, ws, out == tzd)
    out, f, ws = _timed(lambda: oracle.inflate(raw)[0])
    ok &= _ab_line("inflate_walk_foreign_16MiB", "host", f, ws, out == data)

    # LZHUF walk, lh5 and lh7.
    for m in ("lh5", "lh7"):
        b = LZHUF_METHODS[m][0]
        body = oracle.lzhuf_encode(data, b, 16)
        for w in turns:
            out, f, ws = _timed(lambda: lzhuf_walk.decompress(
                body, len(data), b, walk=w))
            ok &= _ab_line(f"lzhuf_walk_{m}_16MiB", w, f, ws, out == data)
        out, f, ws = _timed(lambda: oracle.lzhuf_decode(body, len(data), b))
        ok &= _ab_line(f"lzhuf_walk_{m}_16MiB", "host", f, ws, out == data)

    # bzip2: the walk has no plain twin; the host decoder beside it. The
    # list-ranking iBWT alone on the real last columns.
    enc = oracle.bzip2_encode(data, 9)
    for side, fn in (("device", lambda: bzip2_pipeline.decompress_walk(enc)),
                     ("host", lambda: oracle.bzip2_decode(enc))):
        out, f, ws = _timed(fn)
        ok &= _ab_line("bzip2_decode_l9_16MiB", side, f, ws, out == data)
    blob, offs, blens, origs, _ = oracle.bzip2_scan_to_last(enc)
    last = np.zeros((len(offs), 1 << (int(blens.max()) - 1).bit_length()),
                    np.uint8)
    for k in range(len(offs)):
        last[k, :blens[k]] = blob[offs[k]:offs[k] + blens[k]]
    out, f, ws = _timed(lambda: ibwt_blocks_fast(last, blens, origs))
    ok &= _ab_line("ibwt_list_ranking_l9_16MiB", "reference", f, ws,
                   out is not None)

    # Host against device through tpz.api, for every decode.
    cases = [("gzip", gz, tzd), ("zlib", zlib.compress(data, 6), data),
             ("bzip2", enc, data)]
    cases += [(m, api.compress(data, m, backend="oracle"), data)
              for m in ("lh5", "lh7")]
    for fmt, blob, plain in cases:
        for side in ("device", "oracle", "oracle", "device"):
            out, f, ws = _timed(
                lambda: api.decompress(blob, fmt, backend=side))
            ok &= _ab_line(f"api_decode_{fmt}_16MiB", side, f, ws,
                           out == plain)

    _memory_analysis("2x64MiB", [corpus.mixed(64 * MiB, seed=1),
                                 corpus.mixed(64 * MiB, seed=2)],
                     DeflateConfig(level=6))
    if not ok or sum(device.declines.values()):
        raise SystemExit(f"ab failed (ok={ok}, "
                         f"declines={dict(device.declines)})")


def four_devices() -> None:
    import jax

    from tpz import api, oracle
    from tpz.codecs.deflate import DeflateConfig
    from tpz.kernels.matchfinder import BLOCK
    from tpz.parallel.mesh import (make_mesh, sharded_compress,
                                   sharded_compress_bzip2)
    from tpz.utils import corpus

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    mesh = make_mesh(4)
    params = DeflateConfig(level=6).params_array()

    def gz_ok(data, out):
        nb_per = -(-(-(-len(data) // BLOCK)) // 4)
        span = nb_per * BLOCK
        shards = [data[i * span:(i + 1) * span] for i in range(4)]
        # One shard at a time: the same single-device program as a
        # 32 MiB stream of the one-card run.
        bodies = [api.compress(sh, "deflate", level=6, backend="device")
                  for sh in shards]
        members, off = [], 0
        for body in bodies:
            n = GZ_HDR + len(body) + 8
            members.append(out[off:off + n])
            off += n
        return (off == len(out) and gzip.decompress(out) == data
                and all(m[GZ_HDR:-8] == b == oracle.deflate_encode(s, params)
                        for m, b, s in zip(members, bodies, shards)))

    _phase("sharded_gzip_4x32MiB_l6", 128 * MiB,
           lambda d: sharded_compress(d, mesh, level=6), gz_ok,
           [corpus.mixed(128 * MiB, seed=30),
            corpus.mixed(128 * MiB, seed=32)])

    def bz_ok(data, out):
        one = sharded_compress_bzip2(data, make_mesh(1), level=9)
        return out == one and bz2.decompress(out) == data

    _phase("sharded_bzip2_16MiB_l9", 16 * MiB,
           lambda d: sharded_compress_bzip2(d, mesh, level=9), bz_ok,
           [corpus.mixed(16 * MiB, seed=31),
            corpus.mixed(16 * MiB, seed=33)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="run only the sharded paths on four GPUs")
    mode.add_argument("--ab", action="store_true",
                      help="run only the A/B timings on one GPU")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    print(_smi(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    if args.four:
        four_devices()
    elif args.ab:
        ab()
    else:
        one_device()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
