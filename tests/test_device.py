"""tpz.device (platform choice, backend routing, walk modes, the compile
cache, decline counting) and the Pallas-Triton walks run in the Pallas
interpreter against their plain references at small shapes. Tests marked
`gpu` run the compiled kernels and skip off the GPU."""

import bz2
import zlib

import jax
import numpy as np
import pytest

from tpz import api, device, oracle
from tpz.codecs import gzip_codec
from tpz.utils import corpus


def test_platform_is_cpu_under_tests():
    assert device.platform() == "cpu"
    assert not device.is_accelerator()


def test_auto_backend_uses_host_on_cpu(monkeypatch):
    """backend="auto" must not enter a device pipeline on the CPU."""
    from tpz.kernels import deflate_pipeline

    def boom(*a, **k):
        raise AssertionError("device pipeline entered")

    monkeypatch.setattr(deflate_pipeline, "compress_indexed", boom)
    data = corpus.mixed(5000, seed=1)
    assert not device.use_device("auto")
    blob = api.compress(data, "gzip")
    _, extra = gzip_codec.parse_header_extra(blob, 0)
    assert extra == b""  # the host path writes no block index
    assert api.decompress(blob, "gzip") == data


def test_device_backend_runs_jax_pipeline():
    """backend="device" runs the JAX encode on the configured platform:
    its output carries the encoder's TZ block index, and equals the
    oracle's DEFLATE body."""
    data = corpus.mixed(70_000, seed=2)
    assert device.use_device("device")
    blob = api.compress(data, "gzip", backend="device")
    pos, extra = gzip_codec.parse_header_extra(blob, 0)
    assert gzip_codec.parse_tz_extra(extra) is not None
    body = blob[pos:-8]
    assert body == oracle.deflate_encode(
        data, gzip_codec.deflate.DeflateConfig().params_array())


def test_oracle_backend_and_unknown_backend():
    assert not device.use_device("oracle")
    with pytest.raises(ValueError):
        device.use_device("cuda")


def test_walk_mode_on_cpu():
    """On the CPU the wrappers pick the plain reference; the bzip2
    symbol walk, which has none, runs in the Pallas interpreter."""
    assert device.walk_mode() == "reference"
    assert device.walk_mode(has_reference=False) == "interpret"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: nothing is configured in code.
    Unset: GPU programs cache under the checkout's .jax_cache/; the CPU
    stays uncached."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.configure_compile_cache("gpu") is None
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert device.configure_compile_cache("cpu") is None
    assert jax.config.jax_compilation_cache_dir == before
    try:
        assert device.configure_compile_cache("gpu") == device.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == device.CACHE_DIR
        assert device.CACHE_DIR.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_declines_are_counted():
    """A periodic bzip2 block (multi-cycle LF map) declines the device
    walk: the host decoder answers, and the decline is counted."""
    data = b"abc" * 4000
    enc = oracle.bzip2_encode(data, 1)
    before = sum(device.declines.values())
    assert api.decompress(enc, "bzip2", backend="device") == data
    assert sum(device.declines.values()) > before


@pytest.mark.parametrize("fmt", ["deflate", "zlib", "gzip"])
def test_l2_overflow_decline_takes_host_inflate(fmt, monkeypatch):
    """A valid stream whose Huffman tree overflows the two-level table
    (scan reports lit_bits < 0) is declined by the segment route: every
    framing then decodes it on the host, and the decline is counted."""
    real_scan = oracle.inflate_scan_segments

    def overflowing_scan(*a, **k):
        scan = real_scan(*a, **k)
        scan["lit_bits"] = np.full_like(scan["lit_bits"], -1)
        return scan

    monkeypatch.setattr(oracle, "inflate_scan_segments", overflowing_scan)
    data = corpus.mixed(100_000, seed=17)
    blob = api.compress(data, fmt, backend="oracle")
    before = device.declines["inflate_l2_overflow"]
    assert api.decompress(blob, fmt, backend="device") == data
    assert device.declines["inflate_l2_overflow"] == before + 1


def test_fetch_many_round_trip():
    a, b = device.fetch_many(jax.numpy.arange(3), jax.numpy.ones(2))
    assert a.tolist() == [0, 1, 2] and b.tolist() == [1.0, 1.0]


# ---- Pallas-Triton walks in the interpreter vs their references ----

@pytest.mark.parametrize("level,kind", [(1, "mixed"), (6, "mixed"),
                                        (9, "text"), (0, "mixed")])
def test_inflate_walk_interpret_matches_reference(level, kind):
    """Segment-route decode: the Triton symbol walk (interpreted) and the
    lane-parallel XLA twin write identical markers, so both decode the
    foreign stream to the input (level 0: stored blocks only)."""
    from tpz.kernels import inflate_pipeline as ip

    data = (corpus.mixed(90_000, seed=level) if kind == "mixed"
            else corpus.text(90_000))
    raw = zlib.compress(data, level)[2:-4]
    idx = ip.index_stream(raw)
    ref = ip.decompress_segmented(raw, idx, walk="reference")
    assert ref == data
    assert ip.decompress_segmented(raw, idx, walk="interpret") == ref


def test_inflate_walk_markers_interpret_equal_reference():
    """Marker-level equality of the two walks on one encoder block."""
    from tpz import constants as C
    from tpz.kernels import inflate_pipeline as ip

    data = corpus.mixed(60_000, seed=9)
    stream, bits, lens = gzip_codec.deflate.compress_indexed(
        data, backend="device")
    scan = oracle.inflate_scan_headers(stream, np.asarray(bits))
    slice_ = np.zeros((1, ip.SLICE_BYTES), np.uint8)
    sb = np.frombuffer(stream, np.uint8)[:ip.SLICE_BYTES]
    slice_[0, :sb.size] = sb
    sw = slice_.view("<u4").astype(np.int32)
    tab = np.concatenate([scan["lit_tab"], scan["dist_tab"]], axis=1)
    const = [np.asarray(t, np.int32) for t in (
        C.DEFLATE_LENGTH_BASE, C.DEFLATE_LENGTH_EXTRA,
        C.DEFLATE_DIST_BASE, C.DEFLATE_DIST_EXTRA)]
    args = (sw, scan["body_bit"].astype(np.int32),
            np.asarray(lens, np.int32), tab.astype(np.int32), *const)
    a = np.asarray(ip._walk_jit(*args, walk="reference"))
    b = np.asarray(ip._walk_jit(*args, walk="interpret"))
    assert np.array_equal(a, b)
    assert (a[0, :int(lens[0])] >> 28 > 0).sum() > 1000  # real tokens


@pytest.mark.parametrize("method", ["lh5", "lh7"])
def test_lzhuf_walk_interpret_matches_reference(method):
    from tpz.constants import LZHUF_METHODS
    from tpz.kernels import lzhuf_walk

    bits = LZHUF_METHODS[method][0]
    data = corpus.mixed(150_000, seed=bits)
    body = oracle.lzhuf_encode(data, bits, 16)
    ref = lzhuf_walk.decompress(body, len(data), bits, walk="reference")
    assert ref == data
    assert lzhuf_walk.decompress(body, len(data), bits,
                                 walk="interpret") == ref


@pytest.mark.parametrize("level", [1, 2])
def test_bzip2_walk_interpret_matches_host_decoder(level):
    """The bzip2 symbol walk (no XLA twin) against the host decoder, on
    stdlib-encoded multi-block streams."""
    from tpz.kernels import bzip2_pipeline

    data = corpus.mixed(level * 100_000 + 30_000, seed=level)
    enc = bz2.compress(data, level)
    assert bzip2_pipeline.decompress_walk(enc) == oracle.bzip2_decode(enc)


def test_ibwt_list_ranking_matches_host():
    """The XLA list-ranking iBWT on the host decoder's last columns
    reproduces the stream (after the host RLE1 inverse and CRCs)."""
    from tpz.kernels.ibwt_walk import ibwt_blocks_fast

    data = corpus.mixed(250_000, seed=4)
    enc = bz2.compress(data, 1)
    blob, offs, lens, origs, _ = oracle.bzip2_scan_to_last(enc)
    last = np.zeros((len(offs), 1 << 17), np.uint8)
    for b in range(len(offs)):
        last[b, :lens[b]] = blob[offs[b]:offs[b] + lens[b]]
    out = ibwt_blocks_fast(last, lens, origs)
    flat = b"".join(out[b, :lens[b]].tobytes() for b in range(len(offs)))
    assert oracle.bzip2_rle1_inverse(
        np.frombuffer(flat, np.uint8), np.cumsum(lens) - lens,
        lens.astype(np.int64), oracle.bzip2_scan_headers(enc)["crcs"]) \
        == data


# ---- compiled kernels (GPU only) ----

@pytest.mark.gpu
def test_triton_walks_compiled_match_reference():
    from tpz.kernels import inflate_pipeline as ip
    from tpz.kernels import lzhuf_walk

    data = corpus.mixed(1 << 20, seed=11)
    raw = zlib.compress(data, 6)[2:-4]
    idx = ip.index_stream(raw)
    assert ip.decompress_segmented(raw, idx, walk="triton") == data
    body = oracle.lzhuf_encode(data, 13, 16)
    assert lzhuf_walk.decompress(body, len(data), 13, walk="triton") == data


@pytest.mark.gpu
def test_bzip2_walk_compiled_matches_host_decoder():
    from tpz.kernels import bzip2_pipeline

    data = corpus.mixed(2 << 20, seed=12)
    enc = bz2.compress(data, 9)
    assert bzip2_pipeline.decompress_walk(enc) == data
