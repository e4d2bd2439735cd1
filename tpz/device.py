"""Which JAX platform runs the device pipelines, and how their walks run.

Every routing decision of the codecs goes through this module:

  - ``platform()`` / ``is_accelerator()``: the platform of
    ``jax.devices()[0]`` ("gpu" on the card, "cpu" under the tests).
  - ``use_device(backend)``: the codecs' ``backend`` argument. "device"
    runs the JAX pipelines on whatever platform JAX is configured for;
    "oracle" runs the C++ host path; "auto" picks the device only on an
    accelerator.
  - ``walk_mode(has_reference)``: how a hand-written Pallas walk runs.
    On the GPU it is always compiled ("triton"); on the CPU the wrapper
    runs its plain-XLA reference where one exists, else the kernel in
    the Pallas interpreter.
  - ``declines``: how many inputs a device route handed back to the host
    decoder, by route. A smoke run on the card fails if any was counted.

The persistent compilation cache is configured here too, the first time a
codec call (``use_device``) or a mesh (``tpz.parallel.mesh.make_mesh``)
asks for the platform: where ``JAX_COMPILATION_CACHE_DIR`` is set
JAX reads it itself and nothing is set in code; otherwise GPU programs are
cached under ``.jax_cache/`` at the root of the checkout. CPU programs are
never cached (XLA:CPU executables have crashed the cache-write pass).
"""

from __future__ import annotations

import collections
import os

import jax
import numpy as np

BACKENDS = ("auto", "device", "oracle")

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

declines: collections.Counter = collections.Counter()

_platform: str | None = None


def configure_compile_cache(plat: str) -> str | None:
    """Point JAX's persistent cache at the checkout's ``.jax_cache/`` for
    GPU programs, unless ``JAX_COMPILATION_CACHE_DIR`` already says where.
    Returns the directory set in code, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or plat != "gpu":
        return None
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def platform() -> str:
    """The JAX platform that runs the device pipelines."""
    global _platform
    if _platform is None:
        _platform = jax.devices()[0].platform
        configure_compile_cache(_platform)
    return _platform


def is_accelerator() -> bool:
    return platform() != "cpu"


def use_device(backend: str) -> bool:
    """Whether a codec call with this ``backend`` runs the JAX pipelines.
    Once the device is chosen its exceptions propagate: there is no
    silent host fallback."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "oracle":
        return False
    # platform() also configures the compile cache, which JAX reads once,
    # at the first compile: every device call must pass here first.
    if backend == "auto" and not is_accelerator():
        return False
    platform()
    from tpz import oracle

    if not oracle.available():
        raise RuntimeError("device pipelines need the C++ oracle library "
                           "(host planning and header scans)")
    return True


def walk_mode(has_reference: bool = True) -> str:
    """'triton' on the GPU; elsewhere 'reference' (the plain XLA twin)
    where one exists, else 'interpret'."""
    if platform() == "gpu":
        return "triton"
    return "reference" if has_reference else "interpret"


def decline(route: str) -> None:
    """Count one input a device route handed to the host decoder."""
    declines[route] += 1


def fetch(x) -> np.ndarray:
    """Blocking device-to-host copy of one array."""
    return np.asarray(jax.device_get(x))


def fetch_many(*xs) -> list[np.ndarray]:
    """Blocking device-to-host copy of several arrays in one call."""
    return [np.asarray(a) for a in jax.device_get(list(xs))]
