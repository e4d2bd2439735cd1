"""Inverse BWT on device by list ranking.

tvec (the LF-mapping permutation, one stable sort of the last column) is
ONE cycle over the n live nodes of a block. Walking it from tvec[orig]
emits the plaintext in forward order: node_0 = tvec[orig], node_{k+1} =
tvec[node_k], out[k] = last[node_k]. Wyllie pointer doubling ranks every
node in ceil(log2(N + 1)) rounds of two gathers over the whole batch, and
one scatter places each byte at its rank. A PERIODIC block, whose LF map
splits into several cycles, leaves nodes off the main cycle and is
reported bad (the host decoder handles it).

A Pallas-Triton splitter-chain walk (one program per ~N/512-node chain,
two passes) was measured against this on the H100 and did not beat it
end to end; see PERF.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpz import device


def _lf_map(last, length, orig, N: int):
    """(tvec [NB, N], start node [NB], live mask): the stable sort of the
    last column gives the LF map; dead columns sort past the live ones."""
    NB = last.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (NB, N), 1)
    live = idx < length[:, None]
    li = last.astype(jnp.int32)
    key = jnp.where(live, (li << 21) | idx, jnp.int32(2**31 - 1))
    tvec = jax.lax.sort(key, dimension=1) & ((1 << 21) - 1)
    start = jnp.take_along_axis(
        tvec, jnp.clip(orig[:, None], 0, N - 1), axis=1)[:, 0]
    return tvec, start, live


def _rank_doubling(nxt, weight, rounds: int):
    """Wyllie list ranking: dist[i] = sum of weight from i to the end of
    its list. nxt [NB, N+1] with column N the NIL sink (weight 0,
    nxt == N); every list ends by pointing at NIL."""
    def rnd(_, c):
        d, p = c
        return (d + jnp.take_along_axis(d, p, axis=1),
                jnp.take_along_axis(p, p, axis=1))

    d, _ = jax.lax.fori_loop(0, rounds, rnd, (weight, nxt))
    return d


def ibwt_body(last, length, orig, *, N: int):
    """last [NB, N] int32 (0-padded), length [NB], orig [NB] ->
    (out [NB, N] uint8 plaintext rows, bad [NB] int32): every node ranked
    by pointer doubling, then one scatter. Traceable — the all-device
    bzip2 decode fuses it after its symbol walk."""
    NB = last.shape[0]
    tvec, start, live = _lf_map(last, length, orig, N)
    NIL = N
    nxt = jnp.where(live & (tvec != start[:, None]), tvec, NIL)
    nxt = jnp.concatenate([nxt, jnp.full((NB, 1), NIL, jnp.int32)], axis=1)
    weight = jnp.concatenate([live.astype(jnp.int32),
                              jnp.zeros((NB, 1), jnp.int32)], axis=1)
    dist = _rank_doubling(nxt, weight, (N + 1).bit_length())[:, :N]
    total = jnp.take_along_axis(dist, start[:, None], axis=1)[:, 0]
    bad = (total != length).astype(jnp.int32)
    pos = jnp.where(live, length[:, None] - dist, N)
    rows = jax.lax.broadcasted_iota(jnp.int32, (NB, N), 0)
    out = jnp.zeros((NB, N + 1), jnp.uint8).at[rows, jnp.clip(pos, 0, N)].set(
        last.astype(jnp.uint8), mode="drop")
    return out[:, :N], bad


_ibwt_jit = jax.jit(ibwt_body, static_argnames=("N",))


def ibwt_blocks_fast(last: np.ndarray, lengths: np.ndarray,
                     origs: np.ndarray) -> np.ndarray | None:
    """[NB, N] last columns -> plaintext rows, or None when a block's LF
    map is not one cycle (a periodic block, or a corrupt one) — the
    caller then uses the host decoder, which handles both."""
    NB, N0 = last.shape
    N = max(256, 1 << (N0 - 1).bit_length())
    lastp = last if N == N0 else np.pad(last, ((0, 0), (0, N - N0)))
    out, bad = device.fetch_many(*_ibwt_jit(
        jnp.asarray(lastp.astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(origs.astype(np.int32)), N=N))
    if int(bad.sum()) != 0:
        return None
    return out[:, :N0]
