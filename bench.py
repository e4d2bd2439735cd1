#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line for the driver.

Headline metric: DEFLATE device-pipeline encode throughput (GB/s per
device) on a Silesia-like synthetic mix (the real Silesia corpus is
unavailable offline; see tpz/utils/corpus.py). vs_baseline is against
the BASELINE.json north-star target of 1 GB/s per device. The bench
refuses to run anywhere but the GPU platform: a CPU number is not a
device measurement.

detail.extra_metrics carries the rest of the codec matrix (VERDICT r1
#10): DEFLATE decode, bzip2 device encode/decode, LZHUF device encode —
so every codec's perf is tracked per round, not just the headline.

Timing includes host planning and all device<->host transfers (honest
end-to-end wall time); each iteration uses different input bytes so no
caching layer can elide work. Set TPZ_TRACE=1 to capture a jax.profiler
trace of the headline loop (tpz/utils/profiling.py) into TPZ_TRACE_DIR.
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _mbs(nbytes: float, secs: float) -> float:
    return round(nbytes / secs / 1e6, 2)


def extra_metrics(size: int):
    """Per-codec encode/decode rates (1 timed iteration each, sized to
    keep total bench wall time in bounds). Failures are recorded, never
    fatal — the headline line must always print. A soft deadline
    (TPZ_BENCH_EXTRA_DEADLINE seconds, default 900) skips remaining rows
    once exceeded."""
    from tpz.utils import corpus

    out = {}
    deadline = time.time() + float(
        os.environ.get("TPZ_BENCH_EXTRA_DEADLINE", 900))

    def run(name, nbytes, fn, warm=False):
        if time.time() > deadline:
            out[name] = {"skipped": "extras deadline"}
            return
        """warm=True times the first call too and reports it as MB_s_cold
        (first dispatch per shape, compile included) alongside the warm
        steady-state MB_s."""
        try:
            if warm:
                t0 = time.time()
                fn()
                cold = _mbs(nbytes, time.time() - t0)
            t0 = time.time()
            fn()
            out[name] = {"MB_s": _mbs(nbytes, time.time() - t0)}
            if warm:
                out[name]["MB_s_cold"] = cold
        except Exception as e:  # noqa: BLE001 — report, don't crash bench
            out[name] = {"error": f"{type(e).__name__}: {e}"}

    mix16 = corpus.mixed(size, seed=41)
    mix16b = corpus.mixed(size, seed=42)

    # DEFLATE — C++ native runtime rows (the production decode path).
    from tpz.codecs import deflate as ddf

    blob = ddf.compress(mix16, backend="oracle")
    run("deflate_decode_host", size, lambda: ddf.decompress(blob))
    run("deflate_encode_host", size,
        lambda: ddf.compress(mix16b, backend="oracle"))

    # Device DEFLATE decode (VERDICT r1 #2): gzip with the block-index
    # side-car -> device-parallel inflate (tpz/kernels/inflate_pipeline).
    from tpz.codecs import gzip_codec as gz

    dsize = min(size, 4 << 20)
    gz_blob = gz.compress(corpus.mixed(dsize, seed=47))
    run("deflate_decode_device", dsize,
        lambda: gz.decompress(gz_blob, backend="device"), warm=True)

    # Batched decode (round 3 serving-shape inverse): every TZ-indexed
    # member across 4 buffers in ONE fused dispatch.
    import tpz.api as api

    dbatch = [corpus.mixed(dsize // 2, seed=60 + i) for i in range(4)]
    dblobs = api.compress_many(dbatch, "gzip")
    run("deflate_decode_device_batched", dsize * 2,
        lambda: api.decompress_many(dblobs, "gzip", backend="device"),
        warm=True)

    # Foreign-stream device decode (round 3, SURVEY §7.4 route 2): no
    # side-car — host segment indexer + the same fused device program.
    import zlib as _zlib

    z_blob = _zlib.compress(corpus.mixed(dsize, seed=48), 6)
    from tpz.codecs import zlib_codec as zc

    run("deflate_decode_device_foreign", dsize,
        lambda: zc.decompress(z_blob, backend="device"), warm=True)

    # BZip2 — device encode (batched BWT) and device decode (iBWT).
    bsize = min(size, 4 << 20)
    bdata = corpus.mixed(bsize, seed=43)
    from tpz.codecs import bzip2 as bz

    bz_blob = {}
    if time.time() > deadline:
        out["bzip2_encode_device"] = {"skipped": "extras deadline"}
        return out
    try:
        # Cold (first dispatch, compile included) and warm steady-state
        # in ONE row, on fresh bytes for the warm pass.
        t0 = time.time()
        bz_blob["c"] = bz.compress(corpus.mixed(bsize, seed=45),
                                   backend="device")
        cold = _mbs(bsize, time.time() - t0)
        t0 = time.time()
        bz.compress(bdata, backend="device")
        out["bzip2_encode_device"] = {
            "MB_s": _mbs(bsize, time.time() - t0), "MB_s_cold": cold}
    except Exception as e:  # noqa: BLE001
        out["bzip2_encode_device"] = {"error": f"{type(e).__name__}: {e}"}
    if "c" in bz_blob:
        run("bzip2_decode_device", bsize,
            lambda: bz.decompress(bz_blob["c"], backend="device"), warm=True)
    else:
        bz_blob["c"] = bz.compress(bdata, backend="oracle")
    run("bzip2_decode_host", bsize,
        lambda: bz.decompress(bz_blob["c"], backend="oracle"))

    # LZHUF lh5 — device encode (warm pass on fresh bytes).
    lsize = min(size, 4 << 20)
    ldata = corpus.mixed(lsize, seed=44)
    from tpz.codecs import lzhuf as lh

    try:
        if time.time() > deadline:
            raise RuntimeError("extras deadline")
        t0 = time.time()
        lh.compress(corpus.mixed(lsize, seed=46), method="lh5",
                    backend="device")
        lh_cold = _mbs(lsize, time.time() - t0)
    except Exception:
        lh_cold = None
    run("lzhuf_encode_device", lsize,
        lambda: lh.compress(ldata, method="lh5", backend="device"))
    if lh_cold is not None and "MB_s" in out.get("lzhuf_encode_device", {}):
        out["lzhuf_encode_device"]["MB_s_cold"] = lh_cold

    # Batched lzhuf encode (round 3): every buffer in ONE stage-1/stage-2
    # invocation, timed warm (VERDICT r3 weak #3).
    lbatch = [corpus.mixed(lsize // 2, seed=51 + i) for i in range(4)]
    lbatch2 = [corpus.mixed(lsize // 2, seed=71 + i) for i in range(4)]
    try:
        if time.time() > deadline:
            raise RuntimeError("extras deadline")
        t0 = time.time()
        lh.compress_many(lbatch2, method="lh5", backend="device")
        lb_cold = _mbs(lsize * 2, time.time() - t0)
        t0 = time.time()
        lh.compress_many(lbatch, method="lh5", backend="device")
        out["lzhuf_encode_device_batched"] = {
            "MB_s": _mbs(lsize * 2, time.time() - t0), "MB_s_cold": lb_cold}
    except Exception as e:  # noqa: BLE001
        out["lzhuf_encode_device_batched"] = {
            "error": f"{type(e).__name__}: {e}"}

    # LZHUF device decode (round 3): host token indexer + MSB walk +
    # shared dense resolution.
    lz_blob = lh.compress(ldata, method="lh5", backend="oracle")
    run("lzhuf_decode_device", lsize,
        lambda: lh.decompress(lz_blob, backend="device"), warm=True)
    run("lzhuf_decode_host", lsize,
        lambda: lh.decompress(lz_blob, backend="oracle"))
    return out


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX platform is "
                 f"{dev.platform!r}")
    size = int(os.environ.get("TPZ_BENCH_BYTES", 16 << 20))
    nbuf = int(os.environ.get("TPZ_BENCH_NBUF", 2))
    iters = int(os.environ.get("TPZ_BENCH_ITERS", 3))
    skip_extra = os.environ.get("TPZ_BENCH_HEADLINE_ONLY")
    from tpz.kernels import deflate_pipeline
    from tpz.utils import corpus

    encode_many = deflate_pipeline.compress_many

    # Headline shape: nbuf independent buffers batch-encoded in ONE device
    # invocation (compress_many) — the production serving shape (SURVEY.md
    # §2.2 DP row). Wall time includes every transfer and the host
    # framing, so the number is end-to-end throughput.
    def make_batch(seed):
        return [corpus.mixed(size, seed=seed + i) for i in range(nbuf)]

    total = size * nbuf
    warm_batch = make_batch(7)
    out = encode_many(warm_batch)
    ratio = sum(len(o) for o in out) / total

    trace_ctx = contextlib.nullcontext()
    if os.environ.get("TPZ_TRACE"):
        from tpz.utils import profiling

        trace_ctx = profiling.trace()
    times = []
    with trace_ctx:
        for i in range(iters):
            batch = make_batch(1000 + nbuf * i)
            t0 = time.time()
            encode_many(batch)
            times.append(time.time() - t0)
    times.sort()
    median = times[len(times) // 2]
    gbps = total / median / 1e9
    detail = {
        "bytes": total,
        "buffers": nbuf,
        "bytes_per_buffer": size,
        "median_s": round(median, 4),
        "all_s": [round(t, 4) for t in times],
        "compression_ratio": round(ratio, 4),
    }
    if not skip_extra:
        detail["extra_metrics"] = extra_metrics(size)
    print(json.dumps({
        "metric": "deflate_encode_silesia_like",
        "value": round(gbps, 4),
        "unit": "GB/s/device",
        "vs_baseline": round(gbps / 1.0, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
