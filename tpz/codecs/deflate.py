"""Raw DEFLATE codec (RFC 1951).

Parity: reference crate src/deflate/ `Deflater`/`Inflater` ([MED] SURVEY.md
§2.1). Two backends share "parse spec v3" and produce identical bytes for
the same profile:
  - "oracle": C++ CPU path (cpp/deflate.cc)
  - "device": the JAX pipelines (tpz/kernels/deflate_pipeline.py,
              inflate_pipeline.py) on JAX's configured platform
  - "auto":   device when that platform is an accelerator, else oracle
(tpz/device.py decides; a chosen device path raises its own errors).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpz import device, oracle
from tpz.errors import DataError


@dataclass(frozen=True)
class DeflateConfig:
    """Level profiles (parse spec v3, cpp/lzss.h): suffix-space candidates
    with top-2 saturated extension. Measured on the 4 MiB mix: level 6 =
    0.3300 vs zlib-6's 0.3322; level 9 = 0.3274 vs zlib-9's 0.3276."""

    level: int = 6
    window: int = 32768
    block_size: int = 65536

    @property
    def max_chain(self) -> int:
        """Suffix neighbors scanned per direction (R)."""
        return 4 if self.level <= 3 else (8 if self.level <= 6 else 32)

    @property
    def lazy(self) -> bool:
        return self.level >= 4

    @property
    def screen_bytes(self) -> int:
        return 32 if self.level >= 7 else 16

    @property
    def max_lazy(self) -> int:
        return 258

    @property
    def suffix_mode(self) -> bool:
        return True

    @property
    def restart(self) -> int:
        """Parse-restart interval (cpp/lzss.h LzssParams.restart): the
        sub-walk granularity that lets the device walk run block_size /
        restart interleaved chains per block. Power of two dividing
        block_size; ratio cost is ~0.05% (a handful of matches truncated
        at each 16 KiB boundary)."""
        return 16384

    def params_array(self):
        return oracle.params_array(
            window=self.window,
            max_chain=self.max_chain,
            block_size=self.block_size,
            lazy=self.lazy,
            max_lazy=self.max_lazy,
            n_extend=2,
            screen_bytes=self.screen_bytes,
            suffix_mode=self.suffix_mode,
            restart=self.restart,
        )


def compress(data: bytes, level: int = 6, backend: str = "auto",
             config: DeflateConfig | None = None) -> bytes:
    cfg = config or DeflateConfig(level=level)
    if device.use_device(backend):
        from tpz.kernels import deflate_pipeline

        return deflate_pipeline.compress(data, cfg)
    return oracle.deflate_encode(data, cfg.params_array())


def compress_indexed(data: bytes, level: int = 6, backend: str = "auto",
                     config: DeflateConfig | None = None):
    """Encode + block index (end bits / output lengths per 64 KiB block) —
    the side-car that enables device-parallel decode. Returns
    (stream, block_bits|None, block_lens|None); the oracle fallback has no
    index."""
    cfg = config or DeflateConfig(level=level)
    if device.use_device(backend):
        from tpz.kernels import deflate_pipeline

        return deflate_pipeline.compress_indexed(data, cfg)
    return oracle.deflate_encode(data, cfg.params_array()), None, None


def compress_flush(data: bytes, level: int = 6,
                   config: DeflateConfig | None = None) -> bytes:
    """Encode an Action::Flush segment (no BFINAL anywhere + sync-flush
    empty stored block). Segments produced by this, followed by one
    `compress` segment, concatenate into a single valid stream."""
    cfg = config or DeflateConfig(level=level)
    return oracle.deflate_encode_flush(data, cfg.params_array())


def decompress(data: bytes, backend: str = "auto") -> bytes:
    plain, consumed = decompress_prefix(data, backend)
    if consumed != len(data):
        raise DataError(f"trailing garbage after deflate stream "
                        f"({len(data) - consumed} bytes)")
    return plain


def decompress_prefix(data: bytes, backend: str = "auto") -> tuple[bytes, int]:
    """Decode a deflate stream that may be followed by more data (framing
    trailers). Returns (plaintext, consumed_bytes).

    On the device path the host-side segment indexer (SURVEY.md §7.4
    route 2, cpp InflateIndex) cuts ANY stream — ours or foreign, no
    side-car needed — into 64 KiB-output segments that decode
    block-parallel on device; streams the indexer or the table scan
    declines (both counted in tpz.device.declines) take the host inflate."""
    if device.use_device(backend):
        from tpz.kernels import inflate_pipeline

        idx = inflate_pipeline.index_stream(data)
        if idx is not None:
            plain = inflate_pipeline.decompress_segmented(data, idx)
            if plain is not None:
                return plain, idx["consumed"]
    return oracle.inflate(data)


def compress_many(datas, level: int = 6, backend: str = "auto",
                  config: DeflateConfig | None = None) -> list[bytes]:
    """Batch encode: one device invocation for many independent streams
    (amortizes per-call dispatch; see deflate_pipeline.compress_many)."""
    cfg = config or DeflateConfig(level=level)
    if device.use_device(backend):
        from tpz.kernels import deflate_pipeline

        return deflate_pipeline.compress_many(list(datas), cfg)
    return oracle.deflate_encode_many(list(datas), cfg.params_array())
