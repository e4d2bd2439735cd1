"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices, so `shard_map` / mesh
logic is exercised without accelerators (SURVEY.md §4 item 3). The
platform is pinned through jax.config before any backend initializes.
Set TPZ_TEST_GPU=1 to run the suite on the GPU instead; tests marked
`gpu` run only there and skip on the CPU.

The C++ oracle is built here, once, before collection: every xdist
worker then loads the same library and collects the same tests.
"""

import os

if not os.environ.get("TPZ_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


import pytest

from tpz import oracle

oracle.available()  # builds cpp/ at first use, under a file lock

# Device-pipeline modules run whole codecs through the plain-XLA twins on
# the CPU — the bulk of the suite's wall clock (VERDICT r3 weak #9).
# `pytest -m "not slow"` (make test-fast) keeps a local run short;
# ci.sh runs everything.
_SLOW_MODULES = {
    "test_inflate_pipeline", "test_bzip2_walk",
    "test_lzhuf_pipeline", "test_deflate_pipeline", "test_bzip2_pipeline",
    "test_ibwt_walk", "test_plan_device",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: whole-codec device-pipeline tests on the CPU")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU platform (skips elsewhere)")


def pytest_collection_modifyitems(config, items):
    for it in items:
        mod = getattr(it, "module", None)
        if mod is not None and mod.__name__ in _SLOW_MODULES:
            it.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX runs on the GPU (decided when
    the test runs, never at import or collection)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs the GPU platform")
