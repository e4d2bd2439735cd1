"""Device DEFLATE pipeline vs C++ oracle — byte-identity differential test
(SURVEY.md §4 item 1). Runs on the CPU backend via conftest; the same jit
code runs on the GPU."""

import zlib

import numpy as np
import pytest

from tpz import oracle
from tpz.utils import corpus

pytestmark = pytest.mark.skipif(
    not oracle.available(), reason="oracle library not built"
)


def pipeline_compress(data):
    from tpz.kernels import deflate_pipeline

    return deflate_pipeline.compress(data)


def oracle_ref(data):
    """Oracle with the SAME profile as the pipeline default (spec v3)."""
    from tpz.codecs.deflate import DeflateConfig

    return oracle.deflate_encode(data, DeflateConfig().params_array())


CASES = {
    "text_4k": corpus.text(4096),
    "text_100k": corpus.text(100_000),     # multi-block
    "mixed_130k": corpus.mixed(130_000),
    "repetitive": corpus.repetitive(70_000),
    "random_70k": corpus.random_bytes(70_000),   # stored blocks
    "skewed": corpus.skewed_bytes(50_000),
    "tiny": b"hello hello hello hello",
    "one": b"x",
    "all_zero": b"\x00" * 100_000,
}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_oracle(name):
    data = CASES[name]
    ours = pipeline_compress(data)
    ref = oracle_ref(data)
    assert ours == ref, (
        f"{name}: device pipeline diverged from oracle "
        f"(len {len(ours)} vs {len(ref)}; first diff at "
        f"{next((i for i, (a, b) in enumerate(zip(ours, ref)) if a != b), 'len')})"
    )
    assert zlib.decompress(ours, -15) == data


def test_pipeline_empty():
    assert pipeline_compress(b"") == oracle.deflate_encode(b"")  # empty: host path


def test_pipeline_block_boundary_sizes():
    for n in (65535, 65536, 65537, 131072, 131073):
        data = corpus.text(n, seed=n)
        ours = pipeline_compress(data)
        assert ours == oracle_ref(data), f"n={n}"


def test_compress_many_matches_individual():
    from tpz.kernels import deflate_pipeline

    datas = [
        corpus.text(100_000),
        b"",
        corpus.random_bytes(70_000),
        b"tiny",
        corpus.repetitive(130_000),
    ]
    batch = deflate_pipeline.compress_many(datas)
    for d, blob in zip(datas, batch):
        assert blob == oracle_ref(d) if d else blob == oracle.deflate_encode(b"")
        if d:
            assert zlib.decompress(blob, -15) == d


def test_compress_many_oversized_batch_splits(monkeypatch):
    """Batches beyond MAX_DEVICE_SPAN split into sequential sub-dispatches
    and oversized single buffers take the (byte-identical) oracle."""
    from tpz.kernels import deflate_pipeline

    monkeypatch.setattr(deflate_pipeline, "MAX_DEVICE_SPAN", 150_000)
    datas = [
        corpus.text(100_000, seed=1),
        corpus.text(90_000, seed=2),
        corpus.text(200_000, seed=3),   # alone exceeds the cap -> oracle
        b"x",
    ]
    batch = deflate_pipeline.compress_many(datas)
    for d, blob in zip(datas, batch):
        assert blob == oracle_ref(d)
        assert zlib.decompress(blob, -15) == d
