"""Greedy LZSS parse (SURVEY.md §7 hard part 1).

The sequential greedy parse is the chain p -> p + step(p) with
step(p) = match_len(p) if a valid match starts at p else 1; the token set
is the set of positions reachable from the block start. The device
computes it by pointer doubling:
S_0 = {0}; S_{r+1} = S_r ∪ f_{2^r}(S_r); f_{2^{r+1}} = f_{2^r}∘f_{2^r}
— every step count has a unique binary decomposition, so the union
enumerates the whole chain in log2(N) gather+scatter rounds. It produces
the identical token stream to cpp/lzss.cc's while-loop (differential-
tested in tests/test_kernels.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpz.kernels.matchfinder import MIN_MATCH


def _parse_doubling(step: jax.Array) -> jax.Array:
    NB, block = step.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 1)
    nxt = jnp.minimum(pos + step, block)
    f = jnp.concatenate([nxt, jnp.full((NB, 1), block, jnp.int32)], axis=1)
    reach = jnp.zeros((NB, block + 1), jnp.int32)
    reach = reach.at[:, 0].set(1)
    nbidx = jax.lax.broadcasted_iota(jnp.int32, (NB, block + 1), 0)
    for _ in range(block.bit_length()):
        reach = reach.at[nbidx, f].max(reach)
        f = f[nbidx, f]
    return reach[:, :block]


def greedy_parse(match_len: jax.Array, match_dist: jax.Array,
                 block_len: jax.Array):
    """match_len/match_dist: [NB, BLOCK] int32 (0 where no match).
    block_len: [NB] int32 — valid bytes in each block.

    Returns:
      is_token [NB, BLOCK] bool — a token starts at this position
      token_idx [NB, BLOCK] int32 — dense token index (valid where is_token)
      ntokens [NB] int32
    """
    NB, block = match_len.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (NB, block), 1)
    step = jnp.where(match_len >= MIN_MATCH, match_len, 1)
    reach = _parse_doubling(step)
    # Positions at/after block_len are not tokens.
    is_token = (reach > 0) & (pos < block_len[:, None])
    cum = jnp.cumsum(is_token.astype(jnp.int32), axis=1)
    token_idx = cum - 1
    ntokens = cum[:, -1]
    return is_token, token_idx, ntokens
