"""Device LZHUF pipeline vs C++ oracle — byte-identity differential test."""

import pytest

from tpz import oracle
from tpz.utils import corpus

pytestmark = pytest.mark.skipif(
    not oracle.available(), reason="oracle library not built"
)

CASES = {
    "text_100k": corpus.text(100_000),
    "mixed": corpus.mixed(130_000),
    "repetitive": corpus.repetitive(70_000),
    "random": corpus.random_bytes(50_000),
    "tiny": b"hello hello hello hello",
    "boundary": corpus.text(32768),
    "boundary+1": corpus.text(32769),
}


@pytest.mark.parametrize("method", ["lh4", "lh5", "lh7"])
@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_oracle(method, name):
    from tpz.codecs.lzhuf import _dict_bits
    from tpz.kernels import lzhuf_pipeline

    data = CASES[name]
    ours = lzhuf_pipeline.compress(data, method)
    ref = oracle.lzhuf_encode(data, _dict_bits(method))
    assert ours == ref, (
        f"{method}/{name}: device diverged (len {len(ours)} vs {len(ref)}, "
        f"first diff "
        f"{next((i for i, (a, b) in enumerate(zip(ours, ref)) if a != b), 'len')})"
    )
    assert oracle.lzhuf_decode(ours, len(data), _dict_bits(method)) == data


def test_pipeline_empty():
    from tpz.kernels import lzhuf_pipeline

    assert lzhuf_pipeline.compress(b"", "lh5") == oracle.lzhuf_encode(b"", 13)


def test_compress_many_batched_identity():
    """Round-3 batching (VERDICT r2 #5): one stage-1/stage-2 invocation
    covers many buffers; bytes identical to the per-buffer path and the
    oracle round-trips them."""
    import tpz.api as api
    from tpz import oracle
    from tpz.kernels import lzhuf_pipeline as lp
    from tpz.utils import corpus

    datas = [corpus.text(50_000), b"", corpus.mixed(120_000, seed=3),
             corpus.repetitive(40_000), b"x"]
    for method in ("lh5", "lh7"):
        outs = lp.compress_many(datas, method=method)
        for d, o in zip(datas, outs):
            if not d:
                assert o == b""
                continue
            assert oracle.lzhuf_decode(
                o, len(d), {"lh5": 13, "lh7": 16}[method]) == d
        singles = [lp.compress(d, method) for d in datas]
        assert outs == singles
    # api-level batch wraps containers per buffer
    outs = api.compress_many([d for d in datas if d], "lh5",
                             backend="device")
    for d, o in zip([d for d in datas if d], outs):
        assert api.decompress(o, "lh5") == d


def test_device_decode_walk():
    """Round-3 lzhuf device decode (VERDICT r2 #5): host token indexer +
    Mosaic MSB walk + shared dense resolution; byte-exact across
    methods, segment carries and multi-block streams."""
    import tpz.api as api
    from tpz import oracle
    from tpz.kernels import lzhuf_walk
    from tpz.utils import corpus

    cases = [corpus.text(120_000), corpus.mixed(200_000, seed=6),
             b"aaaaaaaaaabbbb", corpus.repetitive(90_000), b"x"]
    for bits in (13, 16):
        for data in cases:
            body = oracle.lzhuf_encode(data, bits, 16)
            out = lzhuf_walk.decompress(body, len(data), bits)
            assert out == data
    # wrong orig_size must not crash or return success silently
    body = oracle.lzhuf_encode(cases[0], 13, 16)
    bad = lzhuf_walk.decompress(body, len(cases[0]) + 100, 13)
    assert bad is None or len(bad) == len(cases[0]) + 100
    # container + api plumbing
    c = api.compress(cases[1], "lh5", backend="oracle")
    assert api.decompress(c, "lh5", backend="device") == cases[1]


def test_device_decode_many_batched():
    from tpz import oracle
    from tpz.kernels import lzhuf_walk
    from tpz.utils import corpus

    datas = [corpus.text(90_000), corpus.mixed(150_000, seed=8), b"",
             corpus.repetitive(50_000)]
    items = [(oracle.lzhuf_encode(d, 13, 16) if d else b"", len(d))
             for d in datas]
    outs = lzhuf_walk.decompress_many(items, 13)
    for d, o in zip(datas, outs):
        assert o == d
