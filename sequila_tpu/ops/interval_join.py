"""Device interval-join kernels: overlap bounds, counts, pair emission, nearest.

The reference engine's hot loop queries a per-chromosome interval tree once
per probe row and appends matches to growing vectors (reference
interval_join.rs:1580-1640).  Here the whole probe batch is answered at once:

1. ``overlap_bounds`` — for every probe row and every index level, the
   contiguous match run ``[lb, ub)`` via two batched lexicographic rank
   computations (see ops/ranks.py).  End-inclusive i32 semantics, exactly as
   the reference (`start <= qe AND end >= qs`).
2. ``count_matches`` — exact per-probe-row overlap counts (the BITS count
   generalized over levels).  A `count(*)` query needs nothing else.
3. ``emit_pairs`` — two-pass exact materialization: exclusive-scan the
   counts into offsets, then compute, for each output slot, its (build row,
   probe row) pair with pure arithmetic over the contiguous runs.  Static
   output capacity (bucketed) keeps XLA shapes static; a validity mask marks
   the tail.
4. ``nearest_match`` — the reference's CoitreesNearest semantics
   (interval_join.rs:909-990): one result per probe row; first overlap if
   any, else the nearest interval by genomic distance (ties prefer the
   left/upstream candidate), or NULL (-1) when the equi-key is absent.
   Unlike the reference — which only inspects the two intervals adjacent to
   a binary-search split on `start` and can miss a closer long interval —
   this implementation considers the true nearest in every level.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sequila_tpu.errors import ExecutionError
from sequila_tpu.ops.interval_index import PAD_KEY, PAD_VAL, IntervalIndex, _bucket
from sequila_tpu.ops.ranks import rank_lex_sort

INT32_MAX = np.int32(2**31 - 1)

# Materialization guard: one probe chunk may not emit >= 2^31 pairs (int32
# row indices).  Module constant so regression tests can lower it.
_EMIT_LIMIT = 2**31


# ---------------------------------------------------------------------------
# Bounds (lb, ub) per level
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_levels", "level_offsets", "side"))
def level_ranks(
    levels, keys, vals, qk, qv, *, num_levels: int, level_offsets, side: str
):
    """Per-level, level-local rank of (key, value) tuples.

    Returns [num_levels, m] int32: for each probe and level, the number of
    level entries with (key, val) lexicographically < (side='left') or <=
    (side='right') the query — the primitive behind bounds, coverage
    splits, and nearest candidates."""
    L = num_levels
    m = qk.shape[0]
    lev_q = jnp.repeat(jnp.arange(L, dtype=jnp.int32), m)
    r = rank_lex_sort(
        (levels, keys, vals), (lev_q, jnp.tile(qk, (L,)), jnp.tile(qv, (L,))),
        side=side,
    )
    offs = jnp.asarray(level_offsets, dtype=jnp.int32)[:, None]
    return r.reshape(L, m) - offs


@functools.partial(jax.jit, static_argnames=("num_levels", "level_offsets"))
def _bounds_sort(
    levels, keys, starts, ends, qk, qs, qe, *, num_levels: int, level_offsets
):
    """Rank-by-co-sort strategy (Coitrees/SuperIntervals algorithms)."""
    ub = level_ranks(
        levels, keys, starts, qk, qe,
        num_levels=num_levels, level_offsets=level_offsets, side="right",
    )
    lb = level_ranks(
        levels, keys, ends, qk, qs,
        num_levels=num_levels, level_offsets=level_offsets, side="left",
    )
    return lb, ub


def _level_bsearch_one(keys, vals, qk, q, *, off, pad, strict_less):
    """Level-local rank of (qk, q) in one level's (key, val) slice via
    vectorized binary search — the shared primitive of _bounds_bsearch
    and level_ranks_bsearch."""
    steps = max(1, int(np.ceil(np.log2(pad + 1))))
    # derive the carries from qk (not fresh constants) so they inherit
    # qk's varying manual axes under shard_map — a constant initial carry
    # would type-mismatch the varying carry the body produces
    lo = qk * 0
    hi = lo + pad

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        km = keys[off + jnp.minimum(mid, pad - 1)]
        vm = vals[off + jnp.minimum(mid, pad - 1)]
        if strict_less:  # count entries with (key, val) < (qk, q)
            less = (km < qk) | ((km == qk) & (vm < q))
        else:  # count entries with (key, val) <= (qk, q)
            less = (km < qk) | ((km == qk) & (vm <= q))
        # once lo == hi the search has converged: stop updating
        # (the fixed-step loop would otherwise probe index == pad,
        # reading the next level and overcounting)
        active = lo < hi
        return (
            jnp.where(active & less, mid + 1, lo),
            jnp.where(active & ~less, mid, hi),
        )

    lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


@functools.partial(
    jax.jit, static_argnames=("side", "num_levels", "level_pad", "level_offsets")
)
def level_ranks_bsearch(
    levels, keys, vals, qk, qv, *, side: str, num_levels: int, level_pad,
    level_offsets,
):
    """level_ranks without the co-sort: per-level vectorized binary
    search, O(m log n) gathers instead of an O((n + L*m) log) sort.

    Same [num_levels, m] level-local ranks as ``level_ranks`` — the
    sort-free strategy for the per-shard mesh kernels, where each shard's
    co-sort would redo work the single-chip merge backend already
    eliminated (VERDICT r4 #4).  ``levels`` is accepted (and ignored) for
    signature parity: the level structure is implied by the offsets."""
    del levels
    out = []
    for lv in range(num_levels):
        out.append(
            _level_bsearch_one(
                keys, vals, qk, qv,
                off=level_offsets[lv], pad=level_pad[lv],
                strict_less=side == "left",
            )
        )
    return jnp.stack(out)


@functools.partial(jax.jit, static_argnames=("num_levels", "level_pad", "level_offsets"))
def _bounds_bsearch(
    levels, keys, starts, ends, qk, qs, qe, *, num_levels: int, level_pad, level_offsets
):
    """Vectorized per-level binary search (IntervalTree/ArrayIntervalTree).

    O(m log n) gathers instead of an O((n+m) log(n+m)) sort; wins when the
    probe batch is small relative to the index.
    """
    lbs, ubs = [], []
    for lv in range(num_levels):
        off = level_offsets[lv]
        pad = level_pad[lv]
        ubs.append(
            _level_bsearch_one(keys, starts, qk, qe, off=off, pad=pad,
                               strict_less=False)
        )
        lbs.append(
            _level_bsearch_one(keys, ends, qk, qs, off=off, pad=pad,
                               strict_less=True)
        )
    return jnp.stack(lbs), jnp.stack(ubs)


def overlap_bounds(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Per-level contiguous match runs [lb, ub) for each probe row.

    Returns (lb, ub), each int32 of shape [num_levels, m], level-local.
    """
    if method == "bsearch":
        return _bounds_bsearch(
            index.levels, index.keys, index.starts, index.ends, qk, qs, qe,
            num_levels=index.num_levels,
            level_pad=index.level_pad,
            level_offsets=index.level_offsets,
        )
    return _bounds_sort(
        index.levels, index.keys, index.starts, index.ends, qk, qs, qe,
        num_levels=index.num_levels,
        level_offsets=index.level_offsets,
    )


@jax.jit
def counts_from_bounds(lb, ub):
    """Exact per-probe-row match counts; degenerate (qe < qs-1) rows clip to 0."""
    return jnp.sum(jnp.maximum(ub - lb, 0), axis=0).astype(jnp.int32)


def _sum_rank_partials(bk, bv, qk, qv, side: str):
    """64-bucket partial sums of rank_lex(bq tuple) over ALL queries.

    For count(*) no per-query attribution is needed, so the co-sort can
    drop the query-id operand and the scatter: after sorting
    (key, val, flag) the running count of build entries at each query
    slot IS that query's rank; summing those is permutation-invariant.
    3 sort operands instead of 5.  Partial-sum buckets stay int32-exact
    while n < 2^25 (the operator guards)."""
    n = bk.shape[0]
    m = qk.shape[0]
    bflag = 0 if side == "right" else 1
    ops = (
        jnp.concatenate([bk, qk]),
        jnp.concatenate([bv, qv]),
        jnp.concatenate(
            [
                jnp.full((n,), bflag, jnp.int32),
                jnp.full((m,), 1 - bflag, jnp.int32),
            ]
        ),
    )
    k_s, v_s, f_s = jax.lax.sort(ops, num_keys=3)
    is_build = (f_s == bflag).astype(jnp.int32)
    bcount = jnp.cumsum(is_build) - is_build  # build entries strictly before
    contrib = jnp.where(is_build == 0, bcount, 0)
    # (n+m) is a multiple of 64 by the callers' padding buckets
    return contrib.reshape(-1, 64).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("n_pad", "m_pad"))
def counts_bits_fused(
    lk, ls, le, rk, rs, re, remap_l, remap_r, *, n_pad: int, m_pad: int
):
    """Whole count(*) interval join in ONE device program over resident
    columns: remap per-table dictionary codes into the shared key space
    (tiny gathers), pad, two lexicographic ranks, reduce.

    Returns (total_count, num_degenerate): degenerate (qs > qe) probe rows
    are zeroed by BITS but can still match (stabbing) — a non-zero second
    output tells the caller to re-run via the exact level path.
    """

    def pad(a, fill, size):
        return jnp.concatenate(
            [a, jnp.full((size - a.shape[0],), fill, jnp.int32)]
        )

    bk = pad(remap_l[lk], PAD_KEY, n_pad)
    bs = pad(ls, PAD_VAL, n_pad)
    be = pad(le, PAD_VAL, n_pad)
    qk = pad(remap_r[rk], PAD_KEY, m_pad)
    qs = pad(rs, PAD_VAL, m_pad)
    qe = pad(re, PAD_VAL - 2, m_pad)
    # total = sum(ub) - sum(lb); padding probes contribute n to both sums
    # and cancel.  Exact whenever n_deg == 0 (the caller re-routes
    # otherwise).  Partial 64-buckets instead of one int32 total: x64 is
    # disabled and whole-genome joins exceed 2^31 pairs — the host
    # finishes in int64.  One packed output -> one device->host fetch.
    pu = _sum_rank_partials(bk, bs, qk, qe, side="right")
    pl_ = _sum_rank_partials(bk, be, qk, qs, side="left")
    n_deg = jnp.sum((qs > qe) & (qk < PAD_KEY))
    return jnp.concatenate([pu, -pl_, n_deg[None]])


def total_count_i64(counts, n_build_rows: int) -> int:
    """Host-side exact int64 total of a device counts vector."""
    if n_build_rows < (1 << 24) and counts.shape[0] % 64 == 0:
        partials = _bucket_sums_64(counts)
        return int(np.asarray(partials).astype(np.int64).sum())
    return int(np.asarray(counts).astype(np.int64).sum())


@jax.jit
def _bucket_sums_64(counts):
    return counts.reshape(-1, 64).sum(axis=1)


@jax.jit
def _counts_bits(bs_keys, bs_starts, be_keys, be_ends, qk, qs, qe):
    """BITS count: `#start<=qe - #end<qs` per key segment (Layer & Quinlan
    2012) over two independently sorted arrays — no level structure, two
    rank ops total.  EXACT only for qs <= qe; degenerate rows are zeroed
    here and must be routed to the level-based path by the caller."""
    ub = rank_lex_sort((bs_keys, bs_starts), (qk, qe), side="right")
    lb = rank_lex_sort((be_keys, be_ends), (qk, qs), side="left")
    return jnp.where(qs <= qe, ub - lb, 0).astype(jnp.int32)


def count_matches(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Exact per-probe-row match counts.

    method='bits' uses the 2-rank BITS kernel; it silently zeroes
    degenerate (qs > qe) rows, so callers must pre-check (the join
    operator does).  Other methods go through the level decomposition and
    are exact for every input.
    """
    if method == "bits":
        return _counts_bits(
            index.bs_keys, index.bs_starts, index.be_keys, index.be_ends,
            qk, qs, qe,
        )
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return counts_from_bounds(lb, ub)


# ---------------------------------------------------------------------------
# Pair emission (exact materializing join)
# ---------------------------------------------------------------------------


@jax.jit
def pair_offsets(lb, ub):
    """Probe-major exclusive-scan offsets over per-(probe,level) counts.

    Returns (offsets[m*L + 1] int32, lb_pm[m*L]): output slots of probe row i
    occupy [offsets[i*L], offsets[(i+1)*L]) ordered by level then start.
    """
    counts_pm = jnp.maximum(ub - lb, 0).T.reshape(-1)  # [m*L] probe-major
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts_pm, dtype=jnp.int32)]
    )
    return offsets, lb.T.reshape(-1)


@functools.partial(jax.jit, static_argnames=("capacity", "num_levels", "level_offsets"))
def emit_pairs(
    offsets, lb_pm, pos, base=0, *, capacity: int, num_levels: int, level_offsets
):
    """Materialize (build_row, probe_row) index pairs into a static buffer.

    For output slot j: locate its (probe, level) cell by ranking j in the
    offsets array, then the match is the (j - cell_offset)-th element of the
    cell's contiguous run.  Returns (build_rows, probe_rows, valid) of
    length ``capacity``; slots >= total are masked invalid.

    ``base`` (traced scalar) shifts the emitted slot window to
    [base, base + capacity): the chunked-continuation hook — a caller can
    drain an arbitrarily large pair set through one fixed-capacity compiled
    kernel instead of recompiling at a grown capacity (the distributed
    analog of the reference's capped emission, interval_join.rs:1236-1336).
    """
    L = num_levels
    total = offsets[-1]
    slots = jnp.arange(capacity, dtype=jnp.int32) + base
    flat = (
        jnp.searchsorted(offsets, slots, side="right", method="scan_unrolled")
        .astype(jnp.int32) - 1
    )
    ncells = lb_pm.shape[0]
    flat_c = jnp.clip(flat, 0, ncells - 1)
    probe_row = flat_c // L
    lvl = flat_c % L
    r = slots - offsets[flat_c]
    offs = jnp.asarray(level_offsets, dtype=jnp.int32)
    g = offs[lvl] + lb_pm[flat_c] + r
    build_row = pos[jnp.clip(g, 0, pos.shape[0] - 1)]
    valid = slots < total
    return jnp.where(valid, build_row, -1), jnp.where(valid, probe_row, -1), valid


def sat_sub_i32(qs, max_len):
    """``qs - max(max_len, 0)`` with int32 saturation at INT32_MIN.

    x64 is never enabled, so an ``astype(int64)`` upcast on device would
    silently truncate back to int32 and the "clamp" after it would be a
    no-op — with int32-extreme coordinates the wrapped difference lands
    ABOVE the real starts and matching pairs are silently dropped.  The
    true difference is <= qs (max_len >= 0), so a result above qs is
    exactly the wrap case."""
    raw = qs - jnp.maximum(max_len, 0)
    return jnp.where(raw > qs, jnp.int32(-(2**31)), raw)


@functools.partial(jax.jit, static_argnames=("capacity",))
def _emit_window(keys, starts, ends, pos, lo_q, qk, qs, qe, *, capacity: int):
    """Lapper-style max-extension window emission: candidates are the
    contiguous run of starts in [qs - max_len, qe] within the key segment
    (rust-lapper's layered scan idea); an end mask filters the true
    matches — exact for every query shape, including degenerate stabbing.
    ``lo_q`` is the host-precomputed saturated window floor
    max(qs - max_len, INT32_MIN) — computed in real int64 on the host
    because a device int64 upcast would silently truncate (x64 is off).
    Returns (build_rows, probe_rows, valid) of static ``capacity``."""
    lb = rank_lex_sort((keys, starts), (qk, lo_q), side="left")
    ub = rank_lex_sort((keys, starts), (qk, qe), side="right")
    widths = jnp.maximum(ub - lb, 0)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(widths, dtype=jnp.int32)]
    )
    total = offsets[-1]
    slots = jnp.arange(capacity, dtype=jnp.int32)
    cell = (
        jnp.searchsorted(offsets, slots, side="right", method="scan_unrolled")
        .astype(jnp.int32) - 1
    )
    cell = jnp.clip(cell, 0, qk.shape[0] - 1)
    r = slots - offsets[cell]
    g = jnp.clip(lb[cell] + r, 0, pos.shape[0] - 1)
    in_range = slots < total
    match = in_range & (ends[g] >= qs[cell])
    return jnp.where(match, pos[g], -1), jnp.where(match, cell, -1), match


def materialize_pairs_window(index: IntervalIndex, qk, qs, qe):
    """Exact pair materialization via the candidate-window strategy."""
    keys, starts, ends, pos, max_len = index.window_view
    # candidate total for capacity sizing
    lo_q = np.maximum(
        np.asarray(qs).astype(np.int64) - max_len, -(2**31)
    ).astype(np.int32)
    lb = rank_lex_sort((keys, starts), (qk, jnp.asarray(lo_q)), side="left")
    ub = rank_lex_sort((keys, starts), (qk, qe), side="right")
    # int64 on the host: a dense whole-genome window can exceed int32
    total_cand = int(
        np.maximum(np.asarray(ub).astype(np.int64)
                   - np.asarray(lb).astype(np.int64), 0).sum()
    )
    if total_cand == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), 0
    if total_cand >= _EMIT_LIMIT:
        raise ExecutionError(
            f"window emission would scan {total_cand} candidates (>= 2^31); "
            "enable sequila.interval_join_low_memory or reduce the batch"
        )
    capacity = _bucket(total_cand, minimum=1024)
    b_rows, p_rows, valid = _emit_window(
        keys, starts, ends, pos, jnp.asarray(lo_q), qk, qs, qe, capacity=capacity
    )
    valid = np.asarray(valid)
    b = np.asarray(b_rows)[valid]
    p = np.asarray(p_rows)[valid]
    return b, p, len(b)


def _expand_runs_host(pos_host, g0, cnts, total: int):
    """Expand contiguous runs (global start, length) into build rows.

    Runs arrive probe-major, level-minor; elements ascend within each run —
    the exact order ``emit_pairs`` produces — so the emission strategies
    are interchangeable bit-for-bit.  The C path is one linear pass of
    memcpys; the NumPy fallback stays all-int32 (total < 2^31 by the
    caller guard bounds the cumsum, and g0 - run_start stays within
    int32 before the arange restores the true non-negative index)."""
    from sequila_tpu.native.loader import expand_runs

    out = expand_runs(g0, cnts, pos_host, total)
    if out is not None:
        return out
    run_end = np.cumsum(cnts, dtype=np.int32)
    g = np.repeat(g0 - run_end + cnts, cnts)
    g += np.arange(total, dtype=np.int32)
    return pos_host[g]


def _expand_bounds_host(index: IntervalIndex, lbh, ubh, total: int):
    """Expand per-(probe,level) [L, m] bounds into build rows, host-side.

    Empty (probe,level) cells (most of them — [L, m] is mostly zeros) are
    filtered before the expensive repeats."""
    offs = np.asarray(index.level_offsets, dtype=np.int32)
    cnts_flat = np.maximum(ubh - lbh, 0).T.ravel()
    nz = cnts_flat.nonzero()[0]
    g0 = (lbh + offs[:, None]).T.ravel()[nz]  # global run start per cell
    return _expand_runs_host(index.pos_host, g0, cnts_flat[nz], total)


@jax.jit
def _counts_and_nnz(lb, ub):
    """Per-probe counts with the nonzero-cell count and the max run length
    appended — one packed array so the operator's sizing decision (and the
    uint16 run-length packing decision) costs a single fetch."""
    c = jnp.maximum(ub - lb, 0)
    counts = jnp.sum(c, axis=0).astype(jnp.int32)
    nnz = jnp.sum(c > 0).astype(jnp.int32)
    maxrun = jnp.max(c).astype(jnp.int32)
    return jnp.concatenate([counts, nnz[None], maxrun[None]])


@functools.partial(
    jax.jit, static_argnames=("capacity", "level_offsets", "pack16")
)
def _compact_runs(lb, ub, *, capacity: int, level_offsets, pack16: bool):
    """Compact the nonzero (probe,level) cells of [L, m] bounds into ONE
    dense array — run starts followed by run lengths — probe-major order
    preserved.

    The device->host copy sits on the materialization path, so this
    minimizes both bytes and round trips: empty cells never cross the link, starts and lengths ride a
    single transfer, and when every run length fits in 16 bits (pack16;
    decided from the maxrun the counts fetch carried) two lengths are
    packed per int32 lane — the host unpacks them for free with a
    little-endian uint16 view."""
    offs = jnp.asarray(level_offsets, dtype=jnp.int32)[:, None]
    cnts = jnp.maximum(ub - lb, 0)
    cnts_pm = cnts.T.reshape(-1)
    g0_pm = (lb + offs).T.reshape(-1)
    nz = cnts_pm > 0
    pos = jnp.cumsum(nz.astype(jnp.int32)) - 1
    idx = jnp.where(nz, pos, capacity)  # empties scatter out of bounds
    out_g = jnp.zeros((capacity,), jnp.int32).at[idx].set(g0_pm, mode="drop")
    out_c = jnp.zeros((capacity,), jnp.int32).at[idx].set(cnts_pm, mode="drop")
    if pack16:
        # capacity is always even (_bucket yields powers of two / 64k
        # multiples); values are < 2^16 so the OR is exact bitwise
        out_c = out_c[0::2] | (out_c[1::2] << 16)
    return jnp.concatenate([out_g, out_c])


def materialize_pairs(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Full exact join: returns host-visible (build_rows, probe_rows) arrays.

    One device->host sync fetches the per-probe counts; the probe side is
    then RLE-reconstructed on the host (np.repeat — the reference's emit
    likewise expands the probe side host-side, interval_join.rs:1593-1617).
    For the build side, whichever representation is smaller crosses the
    device link: the [L, m] per-level bounds (expanded to rows host-side
    via ``pos_host``) or the materialized row list from ``emit_pairs``.
    At genome scale total >> L*m, so large joins ship bounds, not rows.
    """
    if method == "window":
        return materialize_pairs_window(index, qk, qs, qe)
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return materialize_pairs_from_bounds(index, lb, ub)


def materialize_pairs_from_bounds(index: IntervalIndex, lb, ub):
    """Exact join from precomputed per-(probe,level) device bounds.

    The post-bounds half of ``materialize_pairs``: callers that computed
    [lb, ub) another way (the sort-free merge backend,
    ops/merge_count.merge_level_bounds) share the counts fetch,
    run compaction, link transfer and host expansion bit-for-bit."""
    packed = np.asarray(_counts_and_nnz(lb, ub))
    counts, nnz, maxrun = packed[:-2], int(packed[-2]), int(packed[-1])
    total64 = int(counts.astype(np.int64).sum())
    if total64 >= _EMIT_LIMIT:
        raise ExecutionError(
            f"probe chunk would materialize {total64} pairs (>= 2^31); "
            "enable sequila.interval_join_low_memory or reduce the batch"
        )
    total = total64
    if total == 0:
        return (
            np.empty(0, np.int32),
            np.empty(0, np.int32),
            0,
        )
    L, m_pad = lb.shape
    if 2 * nnz < min(total, 2 * L * m_pad):
        cap = _bucket(max(nnz, 1), minimum=1024)
        pack16 = maxrun < (1 << 16)
        runs_d = _compact_runs(
            lb, ub, capacity=cap, level_offsets=index.level_offsets,
            pack16=pack16,
        )
        # Overlap the run transfer with the host-side probe-id expansion:
        # the RLE of `counts` needs nothing from the device.
        runs_d.copy_to_host_async()
        p = _probe_ids(counts, total)
        runs = np.asarray(runs_d)
        g0 = runs[:nnz]
        if pack16:
            cnt = _unpack16(runs[cap:], nnz)
        else:
            cnt = runs[cap:cap + nnz]
        b = _expand_runs_host(index.pos_host, g0, cnt, total)
        return b, p, total
    if 2 * L * m_pad < total:
        # Same link discipline as the compact-runs path: lb and ub ride ONE
        # transfer, overlapped with the host-side probe-id expansion.
        bounds_d = jnp.concatenate([lb, ub], axis=0)
        bounds_d.copy_to_host_async()
        p = _probe_ids(counts, total)
        bounds = np.asarray(bounds_d)
        b = _expand_bounds_host(index, bounds[:L], bounds[L:], total)
        return b, p, total
    else:
        offsets, lb_pm = pair_offsets(lb, ub)
        capacity = _bucket(total, minimum=1024)
        build_rows, probe_rows, valid = emit_pairs(
            offsets,
            lb_pm,
            index.pos,
            capacity=capacity,
            num_levels=index.num_levels,
            level_offsets=index.level_offsets,
        )
        b = np.asarray(build_rows[:total])
    return b, _probe_ids(counts, total), total


def _unpack16(packed: np.ndarray, nnz: int) -> np.ndarray:
    """First ``nnz`` uint16 lanes of an int32 array packed as lo | hi<<16.

    The uint16 view is a zero-copy unpack but assumes a little-endian
    host (matching the device-side packing order); big-endian hosts take
    the explicit mask-and-interleave path."""
    import sys

    if sys.byteorder == "little":
        return packed.view(np.uint16)[:nnz]
    out = np.empty(2 * len(packed), np.int32)
    out[0::2] = packed & 0xFFFF
    out[1::2] = (packed >> 16) & 0xFFFF
    return out[:nnz]


def _probe_ids(counts, total: int):
    """RLE-expand per-probe match counts into probe row ids (the reference
    likewise expands the probe side host-side, interval_join.rs:1593-1617)."""
    from sequila_tpu.native.loader import repeat_counts

    p = repeat_counts(counts, total)
    if p is None:
        p = np.repeat(
            np.arange(len(counts), dtype=np.int32), counts.astype(np.int64)
        )
    return p


# ---------------------------------------------------------------------------
# Nearest (CoitreesNearest semantics)
# ---------------------------------------------------------------------------


def _lexmin3(mask, a, b, c):
    """Masked lexicographic (a, b, c) minimum over axis 0.

    Returns (m_a, m_c): the winning a-value and the winner's c-value (the
    row payload).  Empty columns yield (INT32_MAX, INT32_MAX)."""
    a1 = jnp.where(mask, a, INT32_MAX)
    m_a = jnp.min(a1, axis=0)
    m2 = mask & (a == m_a[None, :])
    m_b = jnp.min(jnp.where(m2, b, INT32_MAX), axis=0)
    m3 = m2 & (b == m_b[None, :])
    m_c = jnp.min(jnp.where(m3, c, INT32_MAX), axis=0)
    return m_a, m_c


def _lexmax3(mask, a, b, c):
    """Masked lexicographic (a, b, c) maximum over axis 0 (see _lexmin3)."""
    NEG = jnp.int32(-(2**31))
    a1 = jnp.where(mask, a, NEG)
    m_a = jnp.max(a1, axis=0)
    m2 = mask & (a == m_a[None, :])
    m_b = jnp.max(jnp.where(m2, b, NEG), axis=0)
    m3 = m2 & (b == m_b[None, :])
    m_c = jnp.max(jnp.where(m3, c, NEG), axis=0)
    return m_a, m_c


@functools.partial(jax.jit, static_argnames=("level_offsets", "level_pad"))
def nearest_from_bounds(lb, ub, levels, keys, starts, ends, pos, qk, qs, qe, *, level_offsets, level_pad):
    """One build row per probe row: first overlap, else true nearest, else -1.

    Distance convention matches the reference (interval_join.rs:909-956):
    ``candidate.start - qe`` to the right, ``qs - candidate.end`` to the
    left; ties prefer the left candidate.

    Tie-breaking is CANONICAL (structure-independent), so every execution
    path — this kernel, the NumPy/native host indexes, hash partitioning,
    and skew range-split shards (parallel/skew.py) — picks the same row
    regardless of how the intervals were decomposed or sharded:

    - overlap pick: the overlapping row minimizing (start, end, row)
    - upstream tie (equal max end < qs): maximize (end, start, row)
    - downstream tie (equal min start > qe): minimize (start, end, row)

    Each rule reads off the per-level boundary entries directly: within a
    level (start-sorted, monotone ends) the run boundary entry is exactly
    the level's lexicographic extreme, so the cross-level lex reduction
    yields the global extreme with no extra rank computations.
    """
    L, m = lb.shape
    offs = jnp.asarray(level_offsets, dtype=jnp.int32)[:, None]  # [L,1]
    counts = jnp.maximum(ub - lb, 0)
    has_overlap = jnp.any(counts > 0, axis=0)
    n_total = pos.shape[0]
    lvl_ids = jnp.arange(L, dtype=jnp.int32)[:, None]  # [L,1]

    # Overlap pick: each level's first overlapping entry (at lb) is the
    # level's (start, end, row) minimum; reduce lexicographically.
    g_ov = jnp.clip(offs + lb, 0, n_total - 1)
    ov_ok = counts > 0
    _, overlap_pos = _lexmin3(ov_ok, starts[g_ov], ends[g_ov], pos[g_ov])

    # Left candidates: last entry in each level-segment with end < qs is
    # the level's (end, start, row) maximum among upstream entries.
    gl = jnp.clip(offs + lb - 1, 0, n_total - 1)
    left_ok = (lb > 0) & (keys[gl] == qk[None, :]) & (levels[gl] == lvl_ids)
    left_end, left_pos = _lexmax3(left_ok, ends[gl], starts[gl], pos[gl])
    # dist = qs - end, saturated: wrap from int32-extreme ends would go
    # non-positive (true distance is > 0 since end < qs strictly)
    raw_l = qs - left_end
    left_any = jnp.any(left_ok, axis=0)
    left_dist = jnp.where(left_any, jnp.where(raw_l <= 0, INT32_MAX, raw_l), INT32_MAX)

    # Right candidates: first entry in each level-segment with start > qe
    # is the level's (start, end, row) minimum among downstream entries.
    # ub can equal the level's padded size when the level is bucket-full;
    # clamping would then land on the level's LAST REAL entry (same key,
    # same level) and fabricate a candidate — mask those out explicitly.
    pads = jnp.asarray(level_pad, dtype=jnp.int32)[:, None]
    gr = jnp.clip(offs + ub, 0, n_total - 1)
    right_ok = (
        (ub < pads)
        & (keys[gr] == qk[None, :])
        & (levels[gr] == lvl_ids)
    )
    right_start, right_pos = _lexmin3(right_ok, starts[gr], ends[gr], pos[gr])
    raw_r = right_start - qe
    right_any = jnp.any(right_ok, axis=0)
    right_dist = jnp.where(
        right_any, jnp.where(raw_r <= 0, INT32_MAX, raw_r), INT32_MAX
    )

    best_pos = jnp.where(left_dist <= right_dist, left_pos, right_pos)
    any_cand = left_any | right_any

    return jnp.where(
        has_overlap, overlap_pos, jnp.where(any_cand, best_pos, -1)
    ).astype(jnp.int32)


def nearest_match(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return nearest_from_bounds(
        lb, ub,
        index.levels, index.keys, index.starts, index.ends, index.pos,
        qk, qs, qe,
        level_offsets=index.level_offsets,
        level_pad=index.level_pad,
    )
