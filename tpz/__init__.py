"""tpz — block-batched lossless compression suite on JAX.

JAX/XLA/Pallas framework with the capabilities of the Rust crate
chalharu/rust-compression (see SURVEY.md): DEFLATE + zlib/gzip framing,
BZip2, LZHUF (LHA lh4-lh7), raw LZSS, canonical Huffman, CRC-32 (x2
variants) and Adler-32 — block-batched device pipelines instead of the
crate's byte-serial iterator transducers, plus a bit-exact C++ CPU oracle.
"""

from tpz.action import Action
from tpz.errors import CompressionError, DataError, Unexpected, UnexpectedEof

__version__ = "0.1.0"

__all__ = [
    "Action",
    "CompressionError",
    "DataError",
    "UnexpectedEof",
    "Unexpected",
]
