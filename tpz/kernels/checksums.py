"""Checksum kernels: CRC-32 (gzip reflected + bzip2 MSB variants), Adler-32.

Parity: reference crate src/crc32.rs (table-driven, both variants) and
src/adler32.rs ([MED], SURVEY.md §2.1). Data-parallel design instead of a
byte-serial table loop:

CRC-32 is linear over GF(2): processing one 32-bit word is
``state' = M32 . (state ^ word)`` where ``M32`` is the 32x32 GF(2) matrix
that advances the register by 32 zero bits. The matrix-vector product is 32
lane-wide select+XOR vector ops (no gathers). We split the input into L
contiguous chunks (front-padded with zeros, which is a no-op for a zero-
initialised register), compute chunk CRCs in parallel lanes with a
``fori_loop`` over words, and combine the L partials on the host with the
same GF(2) matrices (combine cost: L * 32 scalar ops).

Adler-32: a = 1 + sum(d) mod 65521 ; b = (n + sum((N - i) * d'_i)) mod 65521
over the front-zero-padded array d' of length N — two weighted tree
reductions with interleaved mods to stay in int32 range.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpz.constants import (
    ADLER32_MOD,
    CRC32_TABLE_MSB,
    CRC32_TABLE_REFLECTED,
)

# --------------------------------------------------------------------------
# GF(2) matrices for CRC advance
# --------------------------------------------------------------------------


def _advance_byte_reflected(state: np.uint64) -> int:
    s = int(state)
    return int((s >> 8) ^ CRC32_TABLE_REFLECTED[s & 0xFF])


def _advance_byte_msb(state: np.uint64) -> int:
    s = int(state)
    return int(((s << 8) & 0xFFFFFFFF) ^ CRC32_TABLE_MSB[(s >> 24) & 0xFF])


def _matrix_from_advance(advance, nbytes: int) -> np.ndarray:
    """Columns of the GF(2) matrix advancing the register by nbytes zero
    bytes: col[j] = advance^nbytes(1 << j)."""
    cols = np.empty(32, dtype=np.uint32)
    for j in range(32):
        s = 1 << j
        for _ in range(nbytes):
            s = advance(s)
        cols[j] = s
    return cols


def _mat_mul_vec(cols: np.ndarray, v: int) -> int:
    out = 0
    vv = int(v)
    for j in range(32):
        if (vv >> j) & 1:
            out ^= int(cols[j])
    return out


def _mat_mul_mat(a_cols: np.ndarray, b_cols: np.ndarray) -> np.ndarray:
    """(A @ B) columns: apply A to each column of B."""
    return np.array([_mat_mul_vec(a_cols, int(c)) for c in b_cols], dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _m32_cols(variant: str) -> np.ndarray:
    adv = _advance_byte_reflected if variant == "reflected" else _advance_byte_msb
    return _matrix_from_advance(adv, 4)


@functools.lru_cache(maxsize=None)
def _shift_matrix(variant: str, nbytes: int) -> np.ndarray:
    """GF(2) matrix advancing by nbytes zero bytes, via repeated squaring."""
    adv = _advance_byte_reflected if variant == "reflected" else _advance_byte_msb
    base = _matrix_from_advance(adv, 1)  # one byte
    result = np.array([np.uint32(1 << j) for j in range(32)], dtype=np.uint32)  # identity
    n = nbytes
    sq = base
    while n:
        if n & 1:
            result = _mat_mul_mat(sq, result)
        sq = _mat_mul_mat(sq, sq)
        n >>= 1
    return result


# --------------------------------------------------------------------------
# Device lane kernel
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("variant",))
def _crc_lanes(words: jax.Array, variant: str) -> jax.Array:
    """Per-lane CRC over contiguous chunks.

    words: [L, M] uint32 — lane l holds chunk l as 32-bit words (little-
    endian byte order for the reflected variant, big-endian for MSB).
    Returns [L] uint32 chunk CRC registers (zero-initialised, no final xor).
    """
    cols = jnp.asarray(_m32_cols(variant))  # [32] uint32
    L, M = words.shape

    def step(i, state):
        x = state ^ words[:, i]
        acc = jnp.zeros_like(state)
        for j in range(32):
            bit = (x >> np.uint32(j)) & np.uint32(1)
            acc = acc ^ (bit * cols[j])
        return acc

    init = jnp.zeros((L,), dtype=jnp.uint32)
    return jax.lax.fori_loop(0, M, step, init)


def _crc32_device(data: np.ndarray, variant: str, lanes: int = 512) -> int:
    n = data.size
    # Pick lane count so each lane has >= 64 words of work.
    while lanes > 1 and n < lanes * 256:
        lanes //= 2
    word_bytes = 4 * lanes
    pad = (-n) % word_bytes
    padded = np.zeros(n + pad, dtype=np.uint8)
    padded[pad:] = data
    total = padded.size
    m = total // word_bytes  # words per lane
    if variant == "reflected":
        words = padded.view("<u4")
    else:
        words = padded.view(">u4").astype(np.uint32)
    words = np.ascontiguousarray(words.reshape(lanes, m, order="C"))
    # NOTE reshape: chunk l must be contiguous bytes. words currently is the
    # word sequence in stream order; reshape(lanes, m) row-major gives lane l
    # words [l*m, (l+1)*m) — contiguous. Correct.
    regs = np.asarray(jax.device_get(_crc_lanes(jnp.asarray(words), variant)))
    # Host combine: total = sum_k Shift((L-1-k)*chunk_bytes) . regs[k]
    chunk_bytes = 4 * m
    shift = _shift_matrix(variant, chunk_bytes)
    acc = 0
    for k in range(lanes):
        acc = _mat_mul_vec(shift, acc) ^ int(regs[k])
    return acc


def _crc32_host(data: np.ndarray, variant: str) -> int:
    """Small-input host path (table-driven, vectorless)."""
    if variant == "reflected":
        tab = CRC32_TABLE_REFLECTED
        s = 0
        for b in data.tolist():
            s = (s >> 8) ^ int(tab[(s ^ b) & 0xFF])
        return s
    tab = CRC32_TABLE_MSB
    s = 0
    for b in data.tolist():
        s = ((s << 8) & 0xFFFFFFFF) ^ int(tab[((s >> 24) ^ b) & 0xFF])
    return s


def crc32(data, variant: str = "reflected", use_device: bool | None = None) -> int:
    """CRC-32 of a byte buffer.

    variant="reflected": gzip/zlib polynomial 0xEDB88320, init 0xFFFFFFFF,
    final XOR 0xFFFFFFFF (equals zlib.crc32).
    variant="msb": bzip2 polynomial 0x04C11DB7 MSB-first, init 0xFFFFFFFF,
    final XOR 0xFFFFFFFF.
    """
    if variant not in ("reflected", "msb"):
        raise ValueError(f"unknown CRC variant {variant!r}")
    data = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.astype(np.uint8, copy=False)
    n = data.size
    if use_device is None:
        use_device = n >= 1 << 14
    # Fold the 0xFFFFFFFF init in as a preliminary register, using linearity:
    # crc_reg(init, M) = Shift(len(M)) . init  ^  crc_reg(0, M).
    if n == 0:
        raw = 0
    elif use_device:
        raw = _crc32_device(data, variant)
    else:
        raw = _crc32_host(data, variant)
    init_part = _mat_mul_vec(_shift_matrix(variant, n), 0xFFFFFFFF)
    return (raw ^ init_part ^ 0xFFFFFFFF) & 0xFFFFFFFF


def crc32_combine(crc_a: int, crc_b: int, len_b: int, variant: str = "reflected") -> int:
    """CRC of concat given CRCs of the parts (both with standard init/xor).

    By linearity the init/final xors cancel: crc(A||B) = Shift(len_b).crc_a
    ^ crc_b (the zlib crc32_combine identity).
    """
    return (_mat_mul_vec(_shift_matrix(variant, len_b), crc_a) ^ crc_b) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Adler-32
# --------------------------------------------------------------------------


def _mod_reduce(x: jax.Array) -> jax.Array:
    """Reduce a 1-D int32 array (values < 65521) to a scalar mod 65521,
    chunking by 1024 so partial sums stay within int32."""
    while x.size > 1:
        pad = (-x.size) % 1024
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
        x = jnp.sum(x.reshape(-1, 1024), axis=1) % ADLER32_MOD
    return x[0]


@jax.jit
def _adler_sums(d: jax.Array, weights: jax.Array) -> tuple[jax.Array, jax.Array]:
    """d: [N] uint8 padded; weights: [N] int32 = (N - i) mod 65521.
    Returns (sum d mod, sum w*d mod)."""
    d32 = d.astype(jnp.int32)
    pad = (-d32.size) % 128
    if pad:
        d32 = jnp.concatenate([d32, jnp.zeros((pad,), jnp.int32)])
        weights = jnp.concatenate([weights, jnp.zeros((pad,), jnp.int32)])
    g = d32.reshape(-1, 128)
    w = weights.reshape(-1, 128)
    s1 = jnp.sum(g, axis=1) % ADLER32_MOD                 # <= 128*255, safe
    s2 = jnp.sum(g * w, axis=1) % ADLER32_MOD             # <= 128*1.67e7, safe
    return _mod_reduce(s1), _mod_reduce(s2)


def adler32(data, use_device: bool | None = None) -> int:
    """Adler-32 (RFC 1950), equals zlib.adler32."""
    data = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.astype(np.uint8, copy=False)
    n = data.size
    if n == 0:
        return 1
    if use_device is None:
        use_device = n >= 1 << 14
    if not use_device:
        a = 1
        b = 0
        for byte in data.tolist():
            a += byte
            b += a
        return ((b % ADLER32_MOD) << 16) | (a % ADLER32_MOD)
    N = n  # no front padding needed; weights handle everything
    weights = ((N - np.arange(N, dtype=np.int64)) % ADLER32_MOD).astype(np.int32)
    s1, s2 = _adler_sums(jnp.asarray(data), jnp.asarray(weights))
    s1 = int(jax.device_get(s1))
    s2 = int(jax.device_get(s2))
    a = (1 + s1) % ADLER32_MOD
    b = (n % ADLER32_MOD + s2) % ADLER32_MOD
    return (b << 16) | a
