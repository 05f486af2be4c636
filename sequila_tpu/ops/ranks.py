"""Vectorized lexicographic rank computation (the engine's `searchsorted`).

Every overlap query in this engine reduces to ranks of query tuples inside a
sorted build-side array (see ops/interval_join.py).  The reference engine
answers the per-row question with pointer-based interval trees (COITrees et
al.); here we instead batch all queries and compute their ranks with one of
two strategies:

- ``rank_lex_sort``: co-sort build tuples and query tuples with
  ``jax.lax.sort`` (multi-operand lexicographic sort, ``num_keys``), then
  read each query's rank off the merged order with a scan.  Everything stays
  int32 — no 64-bit composite keys.
  O((n+m) log(n+m)) with perfect vectorization; the default for large
  probe batches.

- ``rank_lex_bsearch``: classic vectorized binary search over an int64
  composite key (gather per step).  O(m log n), gather-latency-bound;
  better when m << n.

Both return, for each query tuple q, the number of build tuples t with
t < q ('left') or t <= q ('right') in lexicographic order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("side",))
def rank_lex_sort(
    build_keys: tuple[jax.Array, ...],
    query_keys: tuple[jax.Array, ...],
    side: str = "left",
) -> jax.Array:
    """Rank each query tuple among the build tuples by co-sorting.

    ``build_keys`` and ``query_keys`` are matching tuples of 1-D int32
    arrays forming lexicographic sort keys (most significant first).  The
    build side does NOT need to be pre-sorted (the co-sort handles it), but
    in this engine it always is, which keeps the sort cheap.

    side='left'  -> #build < query
    side='right' -> #build <= query
    """
    n = build_keys[0].shape[0]
    m = query_keys[0].shape[0]
    # Tie-break flag: for 'right', equal build tuples sort BEFORE the query
    # so they are counted; for 'left' they sort after.
    bflag = 0 if side == "right" else 1
    qflag = 1 - bflag
    ops = []
    for b, q in zip(build_keys, query_keys):
        ops.append(jnp.concatenate([b.astype(jnp.int32), q.astype(jnp.int32)]))
    flags = jnp.concatenate(
        [
            jnp.full((n,), bflag, dtype=jnp.int32),
            jnp.full((m,), qflag, dtype=jnp.int32),
        ]
    )
    # Carried payload: query id (or -1 for build rows).
    qid = jnp.concatenate(
        [
            jnp.full((n,), -1, dtype=jnp.int32),
            jnp.arange(m, dtype=jnp.int32),
        ]
    )
    sorted_ops = jax.lax.sort((*ops, flags, qid), num_keys=len(ops) + 1)
    qid_s = sorted_ops[-1]
    is_q = qid_s >= 0
    pos = jnp.arange(n + m, dtype=jnp.int32)
    # #build strictly before merged position p = p - #queries before p.
    queries_before = jnp.cumsum(is_q.astype(jnp.int32)) - is_q.astype(jnp.int32)
    rank_at_slot = pos - queries_before
    # Scatter ranks back to query order; build slots dropped.
    ranks = jnp.zeros((m,), dtype=jnp.int32)
    ranks = ranks.at[jnp.where(is_q, qid_s, m)].set(rank_at_slot, mode="drop")
    return ranks


def pack_composite(keys: tuple[jax.Array, ...], bits: tuple[int, ...]) -> jax.Array:
    """Pack int32 key columns into a single int64 lexicographic composite.

    ``bits[i]`` is the bit width reserved for column i (values must be
    non-negative and < 2**bits[i]).  Most-significant column first.
    """
    assert len(keys) == len(bits)
    total = sum(bits)
    if total > 63:
        raise ValueError(f"composite needs {total} bits > 63")
    out = jnp.zeros(keys[0].shape, dtype=jnp.int64)
    for k, b in zip(keys, bits):
        out = (out << b) | k.astype(jnp.int64)
    return out


@functools.partial(jax.jit, static_argnames=("side",))
def rank_composite_bsearch(
    build_comp: jax.Array, query_comp: jax.Array, side: str = "left"
) -> jax.Array:
    """Vectorized binary search of query composites in a sorted build array."""
    return jnp.searchsorted(build_comp, query_comp, side=side, method="scan").astype(
        jnp.int32
    )


def np_rank_lex(build_keys, query_keys, side="left"):
    """NumPy oracle for tests: rank via int64 composites + np.searchsorted."""
    def comp(cols):
        out = np.zeros(len(cols[0]), dtype=np.int64)
        for c in cols:
            out = (out << 21) | (np.asarray(c, dtype=np.int64) + (1 << 20))
        return out

    b = comp(build_keys)
    q = comp(query_keys)
    return np.searchsorted(np.sort(b), q, side=side)
