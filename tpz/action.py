"""Flush-semantics enum — parity with the reference crate's `Action`.

The crate drives its streaming encoders with `Action::{Run, Flush, Finish}`
([HIGH], SURVEY.md §2.1 "Action" row). Our block-oriented device design only
needs these at the streaming API boundary (tpz.api.CodecStream): Run feeds
bytes, Flush forces a block boundary with byte alignment, Finish terminates
the stream (final block / trailer).
"""

from __future__ import annotations

import enum


class Action(enum.Enum):
    RUN = "run"
    FLUSH = "flush"
    FINISH = "finish"
