"""Table-level genomic operations (the engine's bioframe-style API).

The reference exposes only the SQL join surface; its sandbox planned
closest/complement operators that never landed (zero-byte
sandbox/closest.md, sandbox/complement.md — SURVEY.md §2 item 23) and its
vendored superintervals library exposes count/coverage/search through a
Python wheel (reference superintervals/src/superintervals/intervalmap.pyx).
This module is the engine's equivalent operator surface over columnar
Tables, all running through the device kernels.

All functions take/return sequila_tpu.models.table.Table; the interval
columns default to (contig, pos_start, pos_end) and coordinates are
end-inclusive i32, as everywhere in the engine.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import pyarrow as pa

import jax.numpy as jnp

from sequila_tpu.models.table import Table, encode_join_keys
from sequila_tpu.ops import genomic
from sequila_tpu.ops.interval_index import build_interval_index
from sequila_tpu.ops.interval_join import count_matches, materialize_pairs, nearest_match

DEFAULT_COLS = ("contig", "pos_start", "pos_end")


def _mesh(partitions: int):
    """Engine mesh for partitions > 1, else None (single-chip path)."""
    from sequila_tpu.parallel.engine import get_engine_mesh

    return get_engine_mesh(partitions)


def _use_host(*tables) -> bool:
    from sequila_tpu.exec.joins.interval_join import _host_threshold

    return sum(t.num_rows for t in tables) <= _host_threshold()


def _route_perprobe_host(a, b, entry=None) -> bool:
    """Routing for verbs whose device path ships an O(probe)-sized payload
    over the link (coverage: 4 rank vectors, 16 bytes/probe;
    count_overlaps: a 4-byte count per probe).  The link traffic makes the
    materializing cost model the right router; counting JOINs that reduce
    to a scalar keep the plain small-input threshold.  A pair-cache
    ``entry`` that already holds the host index zeroes the model's build
    term, so the host keeps answering repeats of a pair it has indexed."""
    import math

    from sequila_tpu.exec.joins.interval_join import _host_threshold, link_profile
    from sequila_tpu.native.loader import available

    if not available():
        return _use_host(a, b)
    if _host_threshold() == 0:
        return False  # kernel-test override: force the device path
    if entry is not None and entry.get("hidx") is not None:
        return True
    n, m = b.num_rows, a.num_rows
    rtt, bw = link_profile()
    # host: radix index build (~6 ns x n log2 n, measured 1.03 s at
    # 7.7M) + threaded segment searches (~140 ns/probe); device: round
    # trips + the per-probe payload (coverage's 4 rank vectors dominate)
    # + the rank/scatter compute (~100 ns/row measured at genome scale)
    host = 6e-9 * n * math.log2(max(n, 2)) + 140e-9 * m
    dev = 2 * rtt + 20.0 * m / bw + 100e-9 * (n + m)
    return host <= dev


def _prep(table: Table, cols):
    key_col, start_col, end_col = cols
    keys = table.column(key_col)
    starts = table.column_as_i32(start_col)
    ends = table.column_as_i32(end_col)
    return keys, starts, ends


def _encode_single(table: Table, key_cols_spec: tuple, key_cols):
    """Joint codes for a single-table verb, memoized on the Table.

    Single-table verbs (merge, complement, depth) re-encoded their key
    columns per call — a dictionary encode plus, downstream, the
    decoder's np.unique sort (~40 ms combined at 500k rows).  The codes
    depend only on the immutable table and the key-column spec, so one
    memo serves every repeat (and keeps the codes IDENTITY stable, which
    also makes the _code_decoder memo hit)."""
    key = ("verbenc", key_cols_spec)
    hit = table._codes.get(key)
    if hit is None:
        hit = table._codes[key] = encode_join_keys(
            key_cols, [k.slice(0, 0) for k in key_cols]
        )[0]
    return hit


_PAIR_CACHE: "weakref.WeakKeyDictionary" = None  # initialized below
_PAIR_CACHE_MAX = 4  # entries kept per probe table


def _strand_key(table: Table, col: str, flip: bool = False):
    """Strand column normalized for key folding.  ``flip`` swaps +/-
    (opposite-strand matching); every other value ('.', NULL) passes
    through and compares literally."""
    import pyarrow.compute as pc

    s = table.column(col)
    s = s.combine_chunks() if isinstance(s, pa.ChunkedArray) else s
    if not flip:
        return s
    return pc.if_else(
        pc.equal(s, "-"),
        pa.scalar("+"),
        pc.if_else(pc.equal(s, "+"), pa.scalar("-"), s),
    )


def _pair_cache_entry(a: Table, b: Table, cols_a, cols_b,
                      strand=None, strand_col="strand") -> dict:
    """Per-(a, b, cols, strand) memo of encoded keys and the build index.

    Arrow tables are immutable, so repeated dataframe verbs over the
    same pair (coverage then closest then count_overlaps ...) reuse the
    dictionary encoding and the level index instead of rebuilding them
    per call.  Weak-keyed on the probe table; the build table is
    held via weakref and checked by identity (id() alone could be a
    reused address).

    ``strand='same'|'opposite'`` folds the strand column into the join
    key (bedtools -s / -S): dictionary codes over (contig, strand)
    tuples, so every kernel runs unchanged."""
    if strand not in (None, "same", "opposite"):
        raise ValueError("strand must be None, 'same' or 'opposite'")
    global _PAIR_CACHE
    if _PAIR_CACHE is None:
        _PAIR_CACHE = weakref.WeakKeyDictionary()
    per_a = _PAIR_CACHE.setdefault(a, {})
    key = (id(b), tuple(cols_a), tuple(cols_b), strand, strand_col)
    hit = per_a.get(key)
    if hit is not None and hit["b_ref"]() is b:
        return hit
    ka, sa, ea = _prep(a, cols_a)
    kb, sb, eb = _prep(b, cols_b)
    keys_a, keys_b = [ka], [kb]
    if strand is not None:
        keys_a.append(_strand_key(a, strand_col, flip=strand == "opposite"))
        keys_b.append(_strand_key(b, strand_col))
    ca, cb, _ = encode_join_keys(keys_a, keys_b)
    entry = {
        "b_ref": weakref.ref(b),
        "ca": ca, "sa": sa, "ea": ea,
        "cb": cb, "sb": sb, "eb": eb,
        "index": None,
    }
    if len(per_a) >= _PAIR_CACHE_MAX:
        per_a.pop(next(iter(per_a)))
    per_a[key] = entry
    return entry


def _pair_host_index(entry: dict):
    """The (lazily built, cached) host index over the entry's build side."""
    if entry.get("hidx") is None:
        from sequila_tpu.ops.host_join import make_host_index

        entry["hidx"] = make_host_index(
            entry["cb"], entry["sb"], entry["eb"]
        )
    return entry["hidx"]


def _pair_index(entry: dict, to_device=None):
    """The (lazily built, cached) IntervalIndex over the entry's build
    side; ``to_device=np.asarray`` callers get a separately cached
    host-resident variant (their arrays must stay NumPy)."""
    if to_device is np.asarray:
        if entry.get("index_host") is None:
            entry["index_host"] = build_interval_index(
                entry["cb"], entry["sb"], entry["eb"], to_device=np.asarray
            )
        return entry["index_host"]
    if to_device is not None:
        return build_interval_index(
            entry["cb"], entry["sb"], entry["eb"], to_device=to_device
        )
    if entry["index"] is None:
        entry["index"] = build_interval_index(
            entry["cb"], entry["sb"], entry["eb"]
        )
    return entry["index"]


def _encode_pair(a: Table, b: Table, cols_a, cols_b,
                 strand=None, strand_col="strand"):
    e = _pair_cache_entry(a, b, cols_a, cols_b, strand, strand_col)
    return e["ca"], e["sa"], e["ea"], e["cb"], e["sb"], e["eb"]


def _gather_pairs(a, b, ca, sa, ea, cb, sb, eb, partitions, entry=None):
    """All matching (b_row, a_row) index pairs, dispatched over the
    mesh / host-index / device paths (shared by every pair-materializing
    verb).  Mesh results are normalized to (probe asc, build asc) order;
    the host and device paths emit probe-major already."""
    mesh = _mesh(partitions)
    if mesh is not None:
        from sequila_tpu.parallel.partitioned_join import partitioned_pairs

        b_rows, p_rows = partitioned_pairs(
            mesh, cb, np.asarray(sb), np.asarray(eb),
            ca, np.asarray(sa), np.asarray(ea),
        )
        order = np.lexsort((b_rows, p_rows))
        return b_rows[order], p_rows[order]
    # materializing verbs route by the link-vs-host cost model: the pair
    # indices cross the device link either way (see materialize_route_host)
    from sequila_tpu.exec.joins.interval_join import materialize_route_host

    if materialize_route_host(b.num_rows, a.num_rows):
        if entry is not None:
            return _pair_host_index(entry).pairs(ca, sa, ea)
        from sequila_tpu.ops.host_join import make_host_index

        return make_host_index(cb, sb, eb).pairs(ca, sa, ea)
    if entry is not None:
        index = _pair_index(entry)
    else:
        index = build_interval_index(cb, sb, eb)
    b_rows, p_rows, _total = materialize_pairs(
        index, jnp.asarray(ca), jnp.asarray(sa), jnp.asarray(ea)
    )
    return b_rows, p_rows


def _pairs_to_table(a: Table, b: Table, p_rows, b_rows) -> Table:
    """(a_row ++ b_row) output assembly shared by the pair verbs:
    gather both sides, '_b'-suffix b's name collisions."""
    at = a.take(np.asarray(p_rows, np.int64))
    bt = b.take(np.asarray(b_rows, np.int64))
    arrays = list(at.arrow.columns) + list(bt.arrow.columns)
    names = at.column_names + [
        f"{n}_b" if n in at.column_names else n for n in bt.column_names
    ]
    return Table(pa.Table.from_arrays(arrays, names=names))


def overlap(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
            partitions: int = 1, strand=None, strand_col: str = "strand") -> Table:
    """Inner overlap join: all (a_row ++ b_row) pairs with equal contig and
    end-inclusive range overlap.  b is the build side, a the probe side
    (probe order preserved).

    ``partitions > 1`` executes SPMD over a device mesh."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    b_rows, p_rows = _gather_pairs(a, b, ca, sa, ea, cb, sb, eb, partitions, entry)
    return _pairs_to_table(a, b, p_rows, b_rows)


def _merge_verb_plan(entry: dict, b: Table, a: Table, cols_b, cols_a,
                     want4: bool):
    """Cached merge-backend plan for a verb pair (build=b, probe=a), or
    None when the preconditions/packing budget disqualify it.  Strand
    folding rewrites the key column, so callers only come here with
    strand=None (the cached sorted views key on the raw contig column)."""
    key = "merge_plan_cov" if want4 else "merge_plan_cnt"
    if key not in entry:
        from sequila_tpu.ops import merge_count as mc

        try:
            ib = tuple(b.column_names.index(c) for c in cols_b)
            ia = tuple(a.column_names.index(c) for c in cols_a)
        except ValueError:
            entry[key] = None
            return None
        entry[key] = mc.plan_verb_ranks(b, a, ib, ia, want4=want4)
    return entry[key]


def count_overlaps(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
                   out_col: str = "count", partitions: int = 1,
                   strand=None, strand_col: str = "strand") -> Table:
    """a with an appended per-row count of overlapping b intervals — the
    intended semantics of the reference's CoitreesCountOverlaps algorithm
    (see SURVEY.md §2 item 9) and of superintervals `count`.

    ``partitions > 1`` executes SPMD over a device mesh (the engine's
    Partitioned mode; shrinks to the available devices)."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    mesh = _mesh(partitions)
    if mesh is not None:
        from sequila_tpu.parallel.partitioned_join import partitioned_probe_counts

        counts = partitioned_probe_counts(
            mesh, cb, np.asarray(sb), np.asarray(eb),
            ca, np.asarray(sa), np.asarray(ea),
        )
    elif _route_perprobe_host(a, b, entry):
        counts = np.asarray(_pair_host_index(entry).counts(ca, sa, ea))
    else:
        counts = None
        if strand is None and os.environ.get("SEQUILA_COUNT_BACKEND", "merge") == "merge":
            # sort-free merge rank passes over cached sorted views (the
            # same backend as the SQL operator's CountOverlaps path)
            plan = _merge_verb_plan(entry, b, a, cols_b, cols, want4=False)
            if plan is not None:
                from sequila_tpu.ops import merge_count as mc

                counts = np.asarray(mc.merge_probe_count_passes(*plan))[
                    : a.num_rows
                ]
        if counts is None:
            index = _pair_index(entry)
            deg = bool((sa > ea).any())
            b_inv = bool((np.asarray(eb) < np.asarray(sb)).any())
            counts = np.asarray(
                count_matches(
                    index, jnp.asarray(ca), jnp.asarray(sa), jnp.asarray(ea),
                    "sort" if deg or b_inv else "bits",
                )
            )
    return Table(a.arrow.append_column(out_col, pa.array(counts.astype(np.int64))))


def nearest(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
            strand=None, strand_col: str = "strand") -> Table:
    """One row per a-row: first overlapping b interval, else the nearest;
    NULL b-side when a's contig is absent from b (the reference's
    CoitreesNearest semantics with build/probe sides swapped to 'enrich a')."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    from sequila_tpu.exec.joins.interval_join import materialize_route_host

    if materialize_route_host(b.num_rows, a.num_rows):
        rows = _pair_host_index(entry).nearest(ca, sa, ea).astype(np.int64)
    else:
        index = _pair_index(entry)
        rows = np.asarray(
            nearest_match(index, jnp.asarray(ca), jnp.asarray(sa), jnp.asarray(ea))
        ).astype(np.int64)
    null_mask = rows < 0
    bt = b.take(np.where(null_mask, 0, rows), null_mask)
    arrays = list(a.arrow.columns) + list(bt.arrow.columns)
    names = a.column_names + [
        f"{n}_b" if n in a.column_names else n for n in bt.column_names
    ]
    return Table(pa.Table.from_arrays(arrays, names=names))


def closest(a: Table, b: Table, k: int = 1, cols: tuple = DEFAULT_COLS,
            cols_b=None, dist_col: str = "distance",
            strand=None, strand_col: str = "strand") -> Table:
    """k closest b intervals per a row (overlaps first, ties upstream
    first), with a distance column; rows with no same-contig b interval
    produce no output (bedtools `closest -k` flavor)."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    if k == 1:
        # vectorized: the nearest kernel (device) / host nearest — exactly
        # one candidate per a-row, rows with no same-contig b drop out
        from sequila_tpu.exec.joins.interval_join import nearest_route_host

        if nearest_route_host(b.num_rows, a.num_rows):
            rows1 = _pair_host_index(entry).nearest(ca, sa, ea)
        else:
            index = _pair_index(entry)
            rows1 = np.asarray(
                nearest_match(index, jnp.asarray(ca), jnp.asarray(sa), jnp.asarray(ea))
            ).astype(np.int64)
        keep = rows1 >= 0
        a_idx = np.nonzero(keep)[0]
        b_idx = rows1[keep]
        dist = np.where(
            eb[b_idx] < sa[a_idx],
            sa[a_idx].astype(np.int64) - eb[b_idx],
            np.maximum(sb[b_idx].astype(np.int64) - ea[a_idx], 0),
        )
    else:
        from sequila_tpu.native.loader import available

        clean = not bool((sa > ea).any()) and not bool(
            (np.asarray(eb) < np.asarray(sb)).any()
        )
        if available() and clean:
            # threaded native 3-ring merge (O(log n + k) per probe) —
            # ~16x the vectorized numpy path at 500k x 500k
            rows, dists = _pair_host_index(entry).closest_k(ca, sa, ea, k)
        else:
            # host-resident index: closest_k is host-side vectorized
            # numpy, so a device index would only add device round trips
            index = _pair_index(entry, to_device=np.asarray)
            rows, dists = genomic.closest_k(
                index, np.asarray(ca), np.asarray(sa), np.asarray(ea), k=k
            )
        valid = rows >= 0
        a_idx, _ = np.nonzero(valid)  # row-major: (a row asc, rank asc)
        b_idx = rows[valid]
        dist = dists[valid]
    at = a.take(np.asarray(a_idx, np.int64))
    bt = b.take(np.asarray(b_idx, np.int64))
    arrays = (
        list(at.arrow.columns)
        + list(bt.arrow.columns)
        + [pa.array(np.asarray(dist, np.int64))]
    )
    names = (
        at.column_names
        + [f"{n}_b" if n in at.column_names else n for n in bt.column_names]
        + [dist_col]
    )
    return Table(pa.Table.from_arrays(arrays, names=names))


def coverage(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
             partitions: int = 1, strand=None, strand_col: str = "strand") -> Table:
    """a with appended (count, bases) of b-coverage per a interval —
    superintervals `coverage` semantics (reference superintervals.rs:802:
    bases = sum(min(end_i,qe) - max(start_i,qs))).

    ``partitions > 1`` executes SPMD over a device mesh."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    mesh = _mesh(partitions)
    if mesh is not None:
        from sequila_tpu.parallel.partitioned_join import partitioned_coverage

        counts, bases = partitioned_coverage(
            mesh, cb, np.asarray(sb), np.asarray(eb),
            ca, np.asarray(sa), np.asarray(ea),
        )
    elif _route_perprobe_host(a, b, entry):
        hidx = _pair_host_index(entry)
        if hasattr(hidx, "coverage"):
            counts, bases = hidx.coverage(ca, sa, ea)
        else:  # NumPy fallback host index has no coverage; use kernels
            counts, bases = genomic.coverage(build_interval_index(cb, sb, eb), ca, sa, ea)
    else:
        counts = None
        if strand is None and os.environ.get("SEQUILA_COUNT_BACKEND", "merge") == "merge":
            plan = _merge_verb_plan(entry, b, a, cols_b, cols, want4=True)
            if plan is not None:
                from sequila_tpu.ops import merge_count as mc

                ranks = np.asarray(mc.merge_verb_rank4(*plan))[:, : a.num_rows]
                prefix = entry.get("merge_cov_prefix")
                if prefix is None:
                    ib = tuple(b.column_names.index(c) for c in cols_b)
                    _, _, _, bst_vh, _ = b.sorted_interval_view(ib[0], ib[1])
                    _, _, _, ben_vh, _ = b.sorted_interval_view(ib[0], ib[2])
                    psum = np.zeros(len(bst_vh) + 1, np.int64)
                    np.cumsum(bst_vh.astype(np.int64), out=psum[1:])
                    esum = np.zeros(len(ben_vh) + 1, np.int64)
                    np.cumsum(ben_vh.astype(np.int64), out=esum[1:])
                    prefix = entry["merge_cov_prefix"] = (psum, esum)
                counts, bases = mc.coverage_from_ranks(ranks, sa, ea, *prefix)
        if counts is None:
            index = _pair_index(entry)
            counts, bases = genomic.coverage(index, ca, sa, ea)
    t = a.arrow.append_column("count", pa.array(counts))
    t = t.append_column("bases", pa.array(bases))
    return Table(t)


def cluster(a: Table, min_dist: int = 0, cols: tuple = DEFAULT_COLS,
            out_col: str = "cluster", strand: bool = False,
            strand_col: str = "strand") -> Table:
    """a with an appended dense cluster id per row: rows whose intervals
    chain into one merged run (gaps <= min_dist) share an id (bedtools
    cluster; ``strand=True`` clusters per (contig, strand) — -s)."""
    keys, starts, ends = _prep(a, cols)
    key_cols = [keys]
    if strand:
        key_cols.append(_strand_key(a, strand_col))
    codes, _, _ = encode_join_keys(key_cols, [k.slice(0, 0) for k in key_cols])
    cids = genomic.cluster_intervals(codes, starts, ends, min_dist)
    return Table(a.arrow.append_column(out_col, pa.array(cids)))


def map_overlaps(a: Table, b: Table, column: str, ops=("mean",),
                 cols: tuple = DEFAULT_COLS, cols_b=None,
                 partitions: int = 1, strand=None,
                 strand_col: str = "strand") -> Table:
    """a with appended aggregations of b.<column> over the b rows
    overlapping each a interval (bedtools map).  ``ops`` from
    count/sum/mean/min/max/median/collapse/distinct; empty groups yield
    NULL (count 0).  Output columns are named ``<column>_<op>``."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    b_rows, p_rows = _gather_pairs(a, b, ca, sa, ea, cb, sb, eb, partitions, entry)
    vals = b.column_np(column)[np.asarray(b_rows, np.int64)]
    agg = genomic.map_aggregate(p_rows, vals, a.num_rows, ops)
    t = a.arrow
    for op in ops:
        t = t.append_column(f"{column}_{op}", pa.array(agg[op]))
    return Table(t)


def merge(a: Table, min_dist: int = 0, cols: tuple = DEFAULT_COLS,
          strand: bool = False, strand_col: str = "strand") -> Table:
    """Union of intervals per contig (gaps <= min_dist joined).

    ``strand=True`` merges per (contig, strand) and keeps the strand
    column in the output (bedtools merge -s)."""
    keys, starts, ends = _prep(a, cols)
    key_cols = [keys]
    if strand:
        key_cols.append(_strand_key(a, strand_col))
    codes = _encode_single(a, (cols[0], strand and strand_col), key_cols)
    mk, ms, me = genomic.merge_intervals(codes, starts, ends, min_dist)
    # decode contig codes back to values via first occurrence
    decode = _code_decoder(a, cols[0], codes)
    arrays = [decode(mk), pa.array(ms.astype(np.int64)), pa.array(me.astype(np.int64))]
    names = list(cols)
    if strand:
        arrays.append(_code_decoder(a, strand_col, codes)(mk))
        names.append(strand_col)
    return Table(pa.Table.from_arrays(arrays, names=names))


def window(a: Table, b: Table, window: int = 0, left: int | None = None,
           right: int | None = None, cols: tuple = DEFAULT_COLS,
           cols_b=None, partitions: int = 1, strand=None,
           strand_col: str = "strand") -> Table:
    """bedtools window: all (a_row ++ b_row) pairs where b lies within
    ``window`` bp of a (or asymmetric ``left``/``right`` margins); the
    output keeps a's original coordinates — only the match predicate is
    widened."""
    cols_b = cols_b or cols
    lw = window if left is None else left
    rw = window if right is None else right
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    lim = np.int64(2**31)
    sa2 = np.clip(np.asarray(sa, np.int64) - lw, -lim, lim - 1).astype(np.int32)
    ea2 = np.clip(np.asarray(ea, np.int64) + rw, -lim, lim - 1).astype(np.int32)
    b_rows, p_rows = _gather_pairs(a, b, ca, sa2, ea2, cb, sb, eb, partitions, entry)
    return _pairs_to_table(a, b, p_rows, b_rows)


def reldist(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
            detail: bool = False, out_col: str = "reldist",
            strand=None, strand_col: str = "strand") -> Table:
    """bedtools reldist: distribution of relative distances between a's
    midpoints and their flanking b midpoints.  Default output is the
    bedtools summary table (reldist bin, count, total, fraction);
    ``detail=True`` instead appends a per-row ``reldist`` column to a
    (NULL where undefined — contig absent from b or no flank)."""
    cols_b = cols_b or cols
    ca, sa, ea, cb, sb, eb = _encode_pair(a, b, cols, cols_b, strand, strand_col)
    r = genomic.reldist(ca, sa, ea, cb, sb, eb)
    if detail:
        return Table(
            a.arrow.append_column(out_col, pa.array(r, mask=np.isnan(r)))
        )
    vals = r[~np.isnan(r)]
    bins = np.minimum(np.floor(vals * 100).astype(np.int64), 50)
    counts = np.bincount(bins, minlength=51)
    nz = counts.nonzero()[0]
    total = int(len(vals))
    return Table(
        pa.Table.from_arrays(
            [
                pa.array(nz / 100.0),
                pa.array(counts[nz].astype(np.int64)),
                pa.array(np.full(len(nz), total, np.int64)),
                pa.array(counts[nz] / total if total else counts[nz] * 0.0),
            ],
            names=["reldist", "count", "total", "fraction"],
        )
    )


def complement(a: Table, chrom_sizes: dict, cols: tuple = DEFAULT_COLS) -> Table:
    """Gaps not covered by any interval, per contig, within
    ``chrom_sizes[name] = (lo, hi)`` (or ``name: hi`` meaning (0, hi))."""
    keys, starts, ends = _prep(a, cols)
    codes = _encode_single(a, (cols[0], False), [keys])
    codes64 = np.asarray(codes, np.int64)
    # code <-> name maps via unique-codes + one small arrow take (no
    # per-row Python); memoized with the merged runs — chrom_sizes vary
    # between calls, the table-derived pieces do not
    memo = a._codes.get(("complement", tuple(cols)))
    if memo is None:
        uniq, first = np.unique(codes64, return_index=True)
        merged = genomic.merge_intervals(
            np.asarray(codes), np.asarray(starts), np.asarray(ends)
        )
        memo = a._codes[("complement", tuple(cols))] = (uniq, first, merged)
    uniq, first, merged = memo
    kcol = keys.combine_chunks() if isinstance(keys, pa.ChunkedArray) else keys
    uniq_names = kcol.take(pa.array(first)).to_pylist() if len(uniq) else []
    name_of = dict(zip((int(c) for c in uniq), uniq_names))
    code_of = {n: c for c, n in name_of.items()}
    key_sizes = {}
    extra = []
    for name, span in chrom_sizes.items():
        lo, hi = span if isinstance(span, (tuple, list)) else (0, span)
        if name in code_of:
            key_sizes[code_of[name]] = (lo, hi)
        else:
            extra.append((name, lo, hi))
    ck, cs, ce = genomic.complement_intervals(
        codes, starts, ends, key_sizes, merged=merged
    )
    names_out = [name_of[int(c)] for c in ck]
    rows_s = cs.astype(np.int64).tolist()
    rows_e = ce.astype(np.int64).tolist()
    for name, lo, hi in extra:  # contigs with no intervals: full span
        names_out.append(name)
        rows_s.append(lo)
        rows_e.append(hi)
    return Table(
        pa.Table.from_arrays(
            [pa.array(names_out, pa.string()), pa.array(rows_s, pa.int64()), pa.array(rows_e, pa.int64())],
            names=list(cols),
        )
    )


def depth(a: Table, cols: tuple = DEFAULT_COLS) -> Table:
    """Per-base depth runs (pileup): (contig, pos_start, pos_end, depth)."""
    keys, starts, ends = _prep(a, cols)
    codes = _encode_single(a, (cols[0], False), [keys])
    dk, ds, de, dd = genomic.depth_events(codes, starts, ends)
    decode = _code_decoder(a, cols[0], codes)
    return Table(
        pa.Table.from_arrays(
            [
                decode(dk),
                pa.array(ds.astype(np.int64)),
                pa.array(de.astype(np.int64)),
                pa.array(dd.astype(np.int64)),
            ],
            names=[cols[0], cols[1], cols[2], "depth"],
        )
    )


def _code_decoder(table: Table, key_col, codes: np.ndarray):
    """Map int key codes back to their original column values.

    Vectorized: unique codes -> first-occurrence rows (one small arrow
    take), then each decode is a dense-LUT gather + one arrow take —
    no per-row Python.  The unique pass is memoized per (table, column,
    codes identity): verbs hand in the pair-cache's encoded keys, so
    repeated calls (subtract then complement then depth over the same
    tables) skip the 500k-row sort entirely."""
    memo = table._codes.setdefault("_decoders", {})
    mkey = (key_col, id(codes))
    hit = memo.get(mkey)
    if hit is not None and hit[0] is codes:
        return hit[1]
    codes_arr = codes
    codes = np.asarray(codes, dtype=np.int64)
    uniq, first = np.unique(codes, return_index=True)
    col = table.column(key_col)
    vals = col.take(pa.array(first)).combine_chunks()
    lut = np.zeros(int(uniq[-1]) + 1 if len(uniq) else 1, np.int64)
    lut[uniq] = np.arange(len(uniq))

    def decode(code_arr: np.ndarray) -> pa.Array:
        idx = lut[np.asarray(code_arr, dtype=np.int64)]
        return vals.take(pa.array(idx))

    if len(memo) >= 8:
        memo.pop(next(iter(memo)))
    memo[mkey] = (codes_arr, decode)
    return decode


def subtract(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None,
             strand=None, strand_col: str = "strand") -> Table:
    """Sub-ranges of a not covered by any b interval (bedtools subtract;
    ``strand='same'|'opposite'`` subtracts only matching-strand b)."""
    cols_b = cols_b or cols
    entry = _pair_cache_entry(a, b, cols, cols_b, strand, strand_col)
    ca, sa, ea = entry["ca"], entry["sa"], entry["ea"]
    cb, sb, eb = entry["cb"], entry["sb"], entry["eb"]
    merged = entry.get("sub_merged")
    if merged is None:
        merged = entry["sub_merged"] = genomic.merged_subtrahend(cb, sb, eb)
    ok, os_, oe = genomic.subtract_intervals(ca, sa, ea, cb, sb, eb, merged=merged)
    decode = _code_decoder(a, cols[0], ca)
    return Table(
        pa.Table.from_arrays(
            [decode(ok), pa.array(os_.astype(np.int64)), pa.array(oe.astype(np.int64))],
            names=list(cols),
        )
    )


def jaccard(a: Table, b: Table, cols: tuple = DEFAULT_COLS, cols_b=None) -> dict:
    """Jaccard similarity of two interval sets (bedtools jaccard)."""
    cols_b = cols_b or cols
    ka, sa, ea = _prep(a, cols)
    kb, sb, eb = _prep(b, cols_b)
    ca, cb, _ = encode_join_keys([ka], [kb])
    return genomic.jaccard(ca, sa, ea, cb, sb, eb)


def _keys_and_sizes(a: Table, chrom_sizes, cols):
    """(codes, key_sizes) — dictionary codes for the key column plus the
    chrom_sizes dict remapped onto those codes (shared by flank/slop)."""
    keys, starts, ends = _prep(a, cols)
    codes, _, _ = encode_join_keys([keys], [keys.slice(0, 0)])
    key_sizes = None
    if chrom_sizes:
        name_to_code = {}
        for c, name in zip(codes, keys.to_pylist()):
            name_to_code.setdefault(name, int(c))
        key_sizes = {
            name_to_code[n]: (sp if isinstance(sp, (tuple, list)) else (0, sp))
            for n, sp in chrom_sizes.items()
            if n in name_to_code
        }
    return keys, starts, ends, codes, key_sizes


def tile(chrom_sizes: dict, window: int, step: int | None = None,
         cols: tuple = DEFAULT_COLS) -> Table:
    """Fixed-size windows per contig (bedtools makewindows):
    ``chrom_sizes[name] = (lo, hi)`` or ``name: hi`` meaning (0, hi)."""
    names = sorted(chrom_sizes)
    key_sizes = {
        i: (sp if isinstance(sp, (tuple, list)) else (0, sp))
        for i, sp in enumerate(chrom_sizes[n] for n in names)
    }
    k, s_, e = genomic.tile_genome(key_sizes, window, step)
    return Table(
        pa.Table.from_arrays(
            [
                pa.array([names[int(c)] for c in k]),
                pa.array(s_.astype(np.int64)),
                pa.array(e.astype(np.int64)),
            ],
            names=list(cols),
        )
    )


def flank(a: Table, left: int, right: int, chrom_sizes: dict | None = None,
          cols: tuple = DEFAULT_COLS) -> Table:
    """Flanking windows adjacent to each interval (bedtools flank)."""
    _, starts, ends, codes, key_sizes = _keys_and_sizes(a, chrom_sizes, cols)
    fk, fs, fe = genomic.flank(codes, starts, ends, left, right, key_sizes)
    decode = _code_decoder(a, cols[0], codes)
    return Table(
        pa.Table.from_arrays(
            [decode(fk), pa.array(fs.astype(np.int64)), pa.array(fe.astype(np.int64))],
            names=list(cols),
        )
    )


def slop(a: Table, left: int, right: int, chrom_sizes: dict | None = None,
         cols: tuple = DEFAULT_COLS) -> Table:
    """Extend intervals by left/right bases, clamped to contig spans."""
    _, starts, ends, codes, key_sizes = _keys_and_sizes(a, chrom_sizes, cols)
    _, os_, oe = genomic.slop(codes, starts, ends, left, right, key_sizes)
    t = a.arrow.set_column(
        a.column_names.index(cols[1]), cols[1], pa.array(os_.astype(np.int64))
    )
    t = t.set_column(
        a.column_names.index(cols[2]), cols[2], pa.array(oe.astype(np.int64))
    )
    return Table(t)
