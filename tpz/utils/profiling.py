"""Tracing / profiling hooks (SURVEY.md §5 tracing row).

The reference crate has none; ours wraps jax.profiler so any encode/decode
can be captured to a TensorBoard/Perfetto trace, plus a lightweight
wall-clock annotation API that works without the profiler.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a device trace around the enclosed block.

    with profiling.trace("traces"): tpz.api.compress(...)
    then `tensorboard --logdir traces` or open in Perfetto. The default
    directory is traces/ at the root of the checkout (TPZ_TRACE_DIR
    overrides it).
    """
    import jax

    log_dir = log_dir or os.environ.get("TPZ_TRACE_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "traces"))
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)
