"""Standalone LZSS codec.

Parity: reference crate src/lzss/ public `LzssEncoder`/`LzssDecoder`
emitting `LzssCode::{Symbol(u8), Reference{len, pos}}` ([HIGH] SURVEY.md
§2.1). The crate's standalone LZSS serializes codes via a caller-supplied
scheme; our equivalent exposes the token stream directly (as a numpy
array — the block-oriented "iterator of LzssCode") plus a simple tagged-byte
serialization for self-contained round-trips:

  flag byte per 8 codes (bit i set => code i is a reference), literals as
  raw bytes, references as 3 bytes: len-min (1) + pos (2, little-endian).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpz import oracle
from tpz.errors import DataError, UnexpectedEof


@dataclass(frozen=True)
class LzssConfig:
    """Mirror of the crate's LzssEncoder::new(...) parameters."""
    window: int = 32768
    min_match: int = 3
    max_match: int = 258
    max_chain: int = 16
    lazy: bool = False
    block_size: int = 65536

    def params_array(self):
        return oracle.params_array(
            window=self.window, min_match=self.min_match,
            max_match=self.max_match, max_chain=self.max_chain,
            lazy=self.lazy, block_size=self.block_size,
            too_far_rule=False)


def tokenize(data: bytes, config: LzssConfig | None = None) -> np.ndarray:
    """[N, 4] int32 (pos, len, lit, dist); len==0 ⇒ literal (Symbol),
    else a Reference{len, pos=dist}."""
    cfg = config or LzssConfig()
    return oracle.lzss_tokenize(data, cfg.params_array())


def compress(data: bytes, level: int = 6, backend: str = "auto",
             config: LzssConfig | None = None) -> bytes:
    _ = level, backend
    cfg = config or LzssConfig()
    toks = tokenize(data, cfg)
    # Serialization is native (cpp/capi.cc tpz_lzss_pack) — Python never
    # touches per-token data (SURVEY.md §2.1 checklist).
    body = oracle.lzss_pack(toks, cfg.min_match)
    return len(data).to_bytes(8, "little") + body


def decompress(data: bytes, config: LzssConfig | None = None) -> bytes:
    cfg = config or LzssConfig()
    if len(data) < 8:
        raise UnexpectedEof("lzss stream too short")
    n = int.from_bytes(data[:8], "little")
    # Native parse + match expansion (cpp/capi.cc tpz_lzss_unpack); raises
    # DataError on out-of-range refs or refs crossing the declared size,
    # UnexpectedEof on truncation.
    return oracle.lzss_unpack(data[8:], n, cfg.min_match)
