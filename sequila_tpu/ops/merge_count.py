"""Packed-u32 merge-count: BITS count(*) over pre-sorted cached views.

The co-sort count kernel (ops/interval_join.py::counts_bits_fused) pays two
(n+m)-row multi-operand device sorts per query.  But both join sides are
registered tables whose (key, value)-sorted views are cached
(models/table.py::sorted_interval_view), so the only per-query work
fundamentally required is to rank one sorted sequence inside another.

- Every (key, value) tuple is packed into ONE uint32 whose unsigned order
  equals the lexicographic order: per merged key j the value range observed
  across both sides (shifted by the planner's ±lit deltas) is compacted to
  ``[base_j, base_j + span_j)`` with ``base`` the exclusive prefix sum of
  spans.  Feasible whenever the summed spans fit 32 bits — the human genome
  (~3.1 Gbp across contigs) fits with room to spare.  Per-key extrema come
  from cached per-table statistics (Table.per_key_minmax).
- Each packed query is then ranked in the packed table by one vectorized
  binary search (``_rank_sorted``).  A whole-genome table (7.7M rows,
  ~31 MB packed) fits a Hopper card's L2, so the ~23 dependent probes per
  query stay on chip.

Count identity (BITS, Layer & Quinlan 2012 — reference
sequila/sequila-core/src/physical_planner/joins/interval_join.rs:1098-1143
uses per-tree counting; the algebra here is the two-rank difference):

    total = sum_q #{b: start_b <= qe}  -  sum_q #{b: end_b < qs}
          = sum_b [ #{q: qs <= end_b }  -  #{q: qe < start_b } ]

so both passes rank *build* tuples inside a sorted *probe* array (qs-sorted
for the first term, qe-sorted for the second), and padding sentinels
(build PAD = 0xFFFFFFFF, probe PAD = 0xFFFFFFFE) contribute identically to
both passes and cancel.  Exact for non-degenerate probes and non-inverted
builds — the operator routes those away via cached min-diff statistics,
exactly like the co-sort fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PADV = np.int32(2**31 - 1)
_BUILD_PAD = np.uint32(0xFFFFFFFF)
_PROBE_PAD = np.uint32(0xFFFFFFFE)
# headroom: both sentinels must sort above every real packed value
_SPAN_LIMIT = 2**32 - 2
# rank partials over PARTIAL rows must stay int32-exact: ranks are bounded
# by the padded table length, so PARTIAL * m_pad < 2^31
PARTIAL = 64
_M_LIMIT = 1 << 25


def _rank_sorted(a, q, *, strict: bool):
    """Rank each u32 query in the sorted u32 table ``a``.

    strict=True  -> #{a <  q}
    strict=False -> #{a <= q}
    """
    side = "left" if strict else "right"
    return jnp.searchsorted(a, q, side=side, method="scan_unrolled").astype(jnp.int32)


def rank_partials(ranks):
    """Exact int32 partial sums of a rank vector over PARTIAL-row groups;
    the host finishes the sum in int64 (x64 stays off on the device)."""
    return ranks.reshape(-1, PARTIAL).sum(axis=1)


def partials_to_total(partials: np.ndarray) -> int:
    """Pass-1 minus pass-2 total from ``merge_count_passes``' partials."""
    sums = np.asarray(partials).astype(np.int64).sum(axis=1)
    return int(sums[0] - sums[1])


@jax.jit
def _pack_view(k, v, c_tab, pad_sentinel):
    """Monotone (key, value) -> u32 packing of a cached sorted view.

    ``c_tab[k] = (base_k - lo_k + delta) mod 2^32`` folds the segment base,
    the per-key minimum and the planner's ±lit delta into one gather; the
    mod-2^32 add is exact because every true packed value fits 32 bits
    (the caller verified the span).  PAD rows map to the side's sentinel."""
    safe = jnp.clip(k, 0, c_tab.shape[0] - 1)
    packed = c_tab[safe] + v.astype(jnp.uint32)
    return jnp.where(k == PADV, pad_sentinel, packed)


@jax.jit
def merge_count_passes(
    bqs_k, bqs_v, c_bqs,  # build sorted by (k, end):   queries of pass 1
    pqs_k, pqs_v, c_pqs,  # probe sorted by (k, qs):    table of pass 1
    bqe_k, bqe_v, c_bqe,  # build sorted by (k, start): queries of pass 2
    pqe_k, pqe_v, c_pqe,  # probe sorted by (k, qe):    table of pass 2
):
    """Both BITS rank passes + partial sums in one device program.

    Returns (2, n_pad / PARTIAL) int32: pass-1 partials (of #{qs <= end_b}
    over build rows) then pass-2 partials (of #{qe < start_b});
    ``partials_to_total`` combines them in int64.  Build PAD rows rank
    m_pad in both passes and cancel; probe PAD slots (sentinel below the
    build sentinel, above every real pack) are counted by neither pass.
    """
    q1 = _pack_view(bqs_k, bqs_v, c_bqs, _BUILD_PAD)
    a1 = _pack_view(pqs_k, pqs_v, c_pqs, _PROBE_PAD)
    q2 = _pack_view(bqe_k, bqe_v, c_bqe, _BUILD_PAD)
    a2 = _pack_view(pqe_k, pqe_v, c_pqe, _PROBE_PAD)
    r1 = _rank_sorted(a1, q1, strict=False)
    r2 = _rank_sorted(a2, q2, strict=True)
    return jnp.stack([rank_partials(r1), rank_partials(r2)])


@jax.jit
def merge_probe_count_passes(
    pqe_k, pqe_v, c_qe,  # probe sorted by (k, qe):    queries of pass A
    bst_k, bst_v, c_bs,  # build sorted by (k, start): table of pass A
    pqs_k, pqs_v, c_qs,  # probe sorted by (k, qs):    queries of pass B
    ben_k, ben_v, c_be,  # build sorted by (k, end):   table of pass B
    ord_qe, ord_qs,      # sorted-view orders, PAD slots = m_pad (dropped)
):
    """Per-probe BITS counts over cached sorted views (CountOverlaps).

    The count(*) passes above rank *build* tuples in the sorted probe
    arrays (summing over build); the per-probe direction ranks *probe*
    tuples in the sorted build arrays with the SAME four packings:

        count_q = #{b: start_b <= qe_q} - #{b: end_b < qs_q}

    Build rows of smaller joint keys land in both terms (their packed
    start AND end sit in strictly lower u32 segments) and cancel; larger
    keys land in neither; same-key rows reduce to exact BITS.  Probe PAD
    queries rank the whole table in both passes and are sliced away; the
    build side's PAD rows pack to the table sentinel, above every real
    query, so they count in neither term.  Per-pass ranks scatter back to
    original probe row order through the views' permutations (disjoint
    slots — each real probe row appears exactly once per view; PAD slots
    carry the out-of-bounds index m_pad and drop).  Returns the padded
    vector — the caller slices [:num_rows] — so the compiled program is
    shared per capacity bucket, not per exact table size.
    """
    qA = _pack_view(pqe_k, pqe_v, c_qe, _BUILD_PAD)
    aA = _pack_view(bst_k, bst_v, c_bs, _PROBE_PAD)
    qB = _pack_view(pqs_k, pqs_v, c_qs, _BUILD_PAD)
    aB = _pack_view(ben_k, ben_v, c_be, _PROBE_PAD)
    rA = _rank_sorted(aA, qA, strict=False)
    rB = _rank_sorted(aB, qB, strict=True)
    m_pad = pqe_k.shape[0]
    # unique_indices is safe despite every PAD slot carrying the same
    # out-of-bounds index m_pad: mode='drop' discards those updates
    # BEFORE the scatter executes (XLA clamps/drops out-of-range indices
    # at lowering), so the promise only has to hold for the in-range
    # indices — the views' permutations, each real row exactly once.
    cA = jnp.zeros((m_pad,), jnp.int32).at[ord_qe].set(
        rA, mode="drop", unique_indices=True
    )
    cB = jnp.zeros((m_pad,), jnp.int32).at[ord_qs].set(
        rB, mode="drop", unique_indices=True
    )
    return cA - cB


def _joint_domain(remap_b, remap_q, nkeys, mn_b, mx_b, d_b, mn_q, mx_q, d_q):
    """Per-joint-key (lo, base) of one packed u32 domain spanning both
    sides' (shifted) value ranges, or None when the summed spans exceed
    the 32-bit budget."""
    lo = np.full(nkeys, np.iinfo(np.int64).max, np.int64)
    hi = np.full(nkeys, np.iinfo(np.int64).min, np.int64)
    np.minimum.at(lo, remap_b, mn_b + d_b)
    np.maximum.at(hi, remap_b, mx_b + d_b)
    np.minimum.at(lo, remap_q, mn_q + d_q)
    np.maximum.at(hi, remap_q, mx_q + d_q)
    span = np.maximum(hi - lo + 1, 0)  # keys absent from both -> 0
    total = int(span.sum())
    if total > _SPAN_LIMIT:
        return None
    base = np.zeros(nkeys, np.int64)
    np.cumsum(span[:-1], out=base[1:])
    return lo, base


def _c_tab(remap, lo, base, d):
    """Per-row u32 add table folding segment base, per-key minimum and the
    planner delta into one gather (mod-2^32 exact; see _pack_view)."""
    j = remap.astype(np.int64)
    return ((base[j] - lo[j] + d) & 0xFFFFFFFF).astype(np.uint32)


def plan_packing(remap_b, remap_q, views, deltas):
    """Per-key u32 segment bases for both passes, or None if infeasible.

    ``views`` = ((bmin_s, bmax_s), (bmin_e, bmax_e), (qmin_s, qmax_s),
    (qmin_e, qmax_e)) int64 per-LOCAL-code extrema (Table.per_key_minmax);
    ``deltas`` = (d_bs, d_be, d_qs, d_qe).  Returns per-side local-code
    C tables (np.uint32) for the four packed views, or None when a pass's
    summed spans exceed the 32-bit budget.
    """
    (bs_mn, bs_mx), (be_mn, be_mx), (qs_mn, qs_mx), (qe_mn, qe_mx) = views
    d_bs, d_be, d_qs, d_qe = deltas
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1

    # pass 1 packs (end_b + d_be) against (qs + d_qs)
    p1 = _joint_domain(remap_b, remap_q, nkeys, be_mn, be_mx, d_be, qs_mn, qs_mx, d_qs)
    # pass 2 packs (start_b + d_bs) against (qe + d_qe)
    p2 = _joint_domain(remap_b, remap_q, nkeys, bs_mn, bs_mx, d_bs, qe_mn, qe_mx, d_qe)
    if p1 is None or p2 is None:
        return None
    lo1, base1 = p1
    lo2, base2 = p2

    return (
        _c_tab(remap_b, lo1, base1, d_be),  # build (k, end)
        _c_tab(remap_q, lo1, base1, d_qs),  # probe (k, qs)
        _c_tab(remap_b, lo2, base2, d_bs),  # build (k, start)
        _c_tab(remap_q, lo2, base2, d_qe),  # probe (k, qe)
    )


@jax.jit
def merge_verb_rank4(
    pqe_k, pqe_v, pqs_k, pqs_v,  # probe views: (k, qe) and (k, qs)
    bst_k, bst_v, ben_k, ben_v,  # build views: (k, start) and (k, end)
    c_qe2, c_bs2,  # domain 2 (bs, qe):  ub_s = #{start_b <= qe}
    c_qs1, c_be1,  # domain 1 (be, qs):  lb_e = #{end_b  <  qs}
    c_qe3, c_be3,  # domain 3 (be, qe):  ub_e = #{end_b  <= qe}
    c_qs4, c_bs4,  # domain 4 (bs, qs):  lb_s = #{start_b <  qs}
    ord_qe, ord_qs,
):
    """Four per-probe rank passes for the coverage decomposition
    (ops/genomic.py::coverage's level-free algebra) over cached sorted
    views — no device sort.  Cross-key rows land in matched pass pairs
    and cancel in every consumer expression (total = ub_s - lb_e,
    nA = ub_e - lb_e, nB = ub_s - lb_s, and the prefix-sum differences
    esum[ub_e]-esum[lb_e] / psum[ub_s]-psum[lb_s] read same-key rank
    ranges by construction).  Returns (4, m_pad) int32 in probe row
    order: [ub_s, lb_e, ub_e, lb_s]; the caller slices [:, :num_rows].
    """
    ub_s = _rank_sorted(
        _pack_view(bst_k, bst_v, c_bs2, _PROBE_PAD),
        _pack_view(pqe_k, pqe_v, c_qe2, _BUILD_PAD),
        strict=False,
    )
    lb_e = _rank_sorted(
        _pack_view(ben_k, ben_v, c_be1, _PROBE_PAD),
        _pack_view(pqs_k, pqs_v, c_qs1, _BUILD_PAD),
        strict=True,
    )
    ub_e = _rank_sorted(
        _pack_view(ben_k, ben_v, c_be3, _PROBE_PAD),
        _pack_view(pqe_k, pqe_v, c_qe3, _BUILD_PAD),
        strict=False,
    )
    lb_s = _rank_sorted(
        _pack_view(bst_k, bst_v, c_bs4, _PROBE_PAD),
        _pack_view(pqs_k, pqs_v, c_qs4, _BUILD_PAD),
        strict=True,
    )
    m_pad = pqe_k.shape[0]

    def scat(r, o):
        # PAD slots share index m_pad but mode='drop' discards them before
        # the scatter, so unique_indices holds for what actually lands
        # (see merge_probe_count_passes)
        return jnp.zeros((m_pad,), jnp.int32).at[o].set(
            r, mode="drop", unique_indices=True
        )

    return jnp.stack([
        scat(ub_s, ord_qe), scat(lb_e, ord_qs),
        scat(ub_e, ord_qe), scat(lb_s, ord_qs),
    ])


def plan_verb_ranks(build, probe, cols_b, cols_q, *, want4: bool):
    """Device argument tuple for the verb-layer merge rank passes.

    ``cols_*`` are (key, start, end) column INDICES of registered Tables
    (build = the counted side, probe = the enriched side; no ±deltas at
    the verb layer).  want4=False returns ``merge_probe_count_passes``
    args (count_overlaps); want4=True returns ``merge_verb_rank4`` args
    (coverage).  None when the preconditions or the 32-bit span budget
    disqualify the packing — callers fall back to the co-sort kernels.
    """
    from sequila_tpu.models.table import merge_dictionaries

    kb, s_b, e_b = cols_b
    kq, s_q, e_q = cols_q
    if build.num_rows == 0 or probe.num_rows == 0:
        return None
    if build.column(kb).null_count or probe.column(kq).null_count:
        return None
    # degenerate probes / inverted builds break the BITS rank algebra
    if probe.min_i32_diff(e_q, s_q) < 0 or build.min_i32_diff(e_b, s_b) < 0:
        return None
    _, bvals, _ = build.dict_codes(kb)
    _, qvals, _ = probe.dict_codes(kq)
    if len(bvals) and len(qvals) and type(bvals[0]) is not type(qvals[0]):
        return None
    remap_b, remap_q = merge_dictionaries(bvals, qvals)
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1
    bs_mm = build.per_key_minmax(kb, s_b)
    be_mm = build.per_key_minmax(kb, e_b)
    qs_mm = probe.per_key_minmax(kq, s_q)
    qe_mm = probe.per_key_minmax(kq, e_q)

    def dom(b_mm, q_mm):
        return _joint_domain(
            remap_b, remap_q, nkeys, b_mm[0], b_mm[1], 0, q_mm[0], q_mm[1], 0
        )

    d2 = dom(bs_mm, qe_mm)
    d1 = dom(be_mm, qs_mm)
    if d1 is None or d2 is None:
        return None
    c_qe2 = _c_tab(remap_q, *d2, 0)
    c_bs2 = _c_tab(remap_b, *d2, 0)
    c_qs1 = _c_tab(remap_q, *d1, 0)
    c_be1 = _c_tab(remap_b, *d1, 0)

    pqe_k, pqe_v, _, _, _ = probe.sorted_interval_view(kq, e_q)
    pqs_k, pqs_v, _, _, _ = probe.sorted_interval_view(kq, s_q)
    bst_k, bst_v, _, _, _ = build.sorted_interval_view(kb, s_b)
    ben_k, ben_v, _, _, _ = build.sorted_interval_view(kb, e_b)

    cap = int(pqe_k.shape[0])

    def pad_order(order):
        out = np.full(cap, cap, np.int32)
        out[: len(order)] = order
        return out

    ord_qe = jnp.asarray(pad_order(probe.sorted_interval_order(kq, e_q)))
    ord_qs = jnp.asarray(pad_order(probe.sorted_interval_order(kq, s_q)))

    if not want4:
        return (
            pqe_k, pqe_v, jnp.asarray(c_qe2),
            bst_k, bst_v, jnp.asarray(c_bs2),
            pqs_k, pqs_v, jnp.asarray(c_qs1),
            ben_k, ben_v, jnp.asarray(c_be1),
            ord_qe, ord_qs,
        )

    d3 = dom(be_mm, qe_mm)
    d4 = dom(bs_mm, qs_mm)
    if d3 is None or d4 is None:
        return None
    c_qe3 = _c_tab(remap_q, *d3, 0)
    c_be3 = _c_tab(remap_b, *d3, 0)
    c_qs4 = _c_tab(remap_q, *d4, 0)
    c_bs4 = _c_tab(remap_b, *d4, 0)
    return (
        pqe_k, pqe_v, pqs_k, pqs_v,
        bst_k, bst_v, ben_k, ben_v,
        jnp.asarray(c_qe2), jnp.asarray(c_bs2),
        jnp.asarray(c_qs1), jnp.asarray(c_be1),
        jnp.asarray(c_qe3), jnp.asarray(c_be3),
        jnp.asarray(c_qs4), jnp.asarray(c_bs4),
        ord_qe, ord_qs,
    )


def coverage_from_ranks(ranks, qs, qe, psum, esum):
    """Host int64 finish of the coverage decomposition over merge ranks.

    ``ranks`` = (4, m) int32 [ub_s, lb_e, ub_e, lb_s] in probe row order
    (merge_verb_rank4); ``psum``/``esum`` = int64 exclusive prefix sums of
    the build's (k,start)-view starts / (k,end)-view ends.  Same algebra
    as ops/genomic.py::coverage's level-free branch."""
    ub_s = ranks[0].astype(np.int64)
    lb_e = ranks[1].astype(np.int64)
    ub_e = ranks[2].astype(np.int64)
    lb_s = ranks[3].astype(np.int64)
    total = ub_s - lb_e
    nA = ub_e - lb_e
    nB = ub_s - lb_s
    sumA_end = esum[ub_e] - esum[lb_e]
    sumB_start = psum[ub_s] - psum[lb_s]
    qe64 = np.asarray(qe).astype(np.int64)
    qs64 = np.asarray(qs).astype(np.int64)
    sum_min_end = sumA_end + qe64 * (total - nA)
    sum_max_start = sumB_start + qs64 * (total - nB)
    return total, sum_min_end - sum_max_start


# ---------------------------------------------------------------------------
# Merge-based level bounds: pair emission without device sorts
# ---------------------------------------------------------------------------


def plan_level_bounds(index, probe, r_key, qs_cd, qe_cd, bs_cd, be_cd,
                      remap_b, remap_q, views):
    """Per-level merge-rank plan for emission bounds, or None.

    Replaces the co-sort bounds pass of the device materialize path
    (ops/interval_join._bounds_sort — two (n + L*m)-row multi-operand
    device sorts; role-equivalent of the reference's per-row emission hot
    loop, reference joins/interval_join.rs:1580-1640) with 2L sort-free
    rank passes: each level slice of the build index is sorted by (key, start) AND — by the monotone-
    end level invariant — simultaneously by (key, end), so both bounds of
    every level rank the cached sorted probe views in an already-sorted
    packed-u32 array.  Exact for every query shape (degenerate stabbing
    probes, inverted build rows): the level-run identity needs no BITS
    subset argument, so this route is WIDER than the merge count path.

    ``index``: IntervalIndex over JOINT key codes, with the planner's
    ±lit bound deltas already applied to its stored starts/ends (the
    exec layer builds it that way) — so the index-side C tables carry
    delta 0 while the domains span the raw extrema + delta.  ``views`` =
    per-LOCAL-code extrema of the four raw columns (Table.per_key_minmax
    order: bs, be, qs, qe); ``*_cd`` = (column index, delta).  Returns an
    opaque plan consumed by ``merge_level_bounds``; None when the 32-bit
    span budget or the plan shape disqualifies packing.
    """
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1
    if nkeys <= 0 or index.n_rows == 0:
        return None
    bs_mm, be_mm, qs_mm, qe_mm = views
    d_bs, d_be, d_qs, d_qe = bs_cd[1], be_cd[1], qs_cd[1], qe_cd[1]
    # domain 2 packs build starts against probe ends; domain 1 packs
    # build ends against probe starts — same pairing as the count path
    d2 = _joint_domain(
        remap_b, remap_q, nkeys, bs_mm[0], bs_mm[1], d_bs, qe_mm[0], qe_mm[1], d_qe
    )
    d1 = _joint_domain(
        remap_b, remap_q, nkeys, be_mm[0], be_mm[1], d_be, qs_mm[0], qs_mm[1], d_qs
    )
    if d1 is None or d2 is None:
        return None
    ident = np.arange(nkeys, dtype=np.int32)
    # index level arrays store raw+delta values -> joint-key C tables with
    # delta 0; probe views store raw values -> local-code C tables with
    # the planner delta folded in
    c_bj2 = jnp.asarray(_c_tab(ident, *d2, 0))
    c_bj1 = jnp.asarray(_c_tab(ident, *d1, 0))
    c_qe = jnp.asarray(_c_tab(remap_q, *d2, d_qe))
    c_qs = jnp.asarray(_c_tab(remap_q, *d1, d_qs))

    pqe_k, pqe_v, _, _, _ = probe.sorted_interval_view(r_key, qe_cd[0])
    pqs_k, pqs_v, _, _, _ = probe.sorted_interval_view(r_key, qs_cd[0])
    m_pad = int(pqe_k.shape[0])
    if m_pad != int(pqs_k.shape[0]):
        return None

    def pad_order(order):
        out = np.full(m_pad, m_pad, np.int32)  # PAD slots scatter-drop
        out[: len(order)] = order
        return out

    ord_qe = jnp.asarray(pad_order(probe.sorted_interval_order(r_key, qe_cd[0])))
    ord_qs = jnp.asarray(pad_order(probe.sorted_interval_order(r_key, qs_cd[0])))

    levels = []
    for lv in range(index.num_levels):
        if index.level_sizes[lv] == 0:
            levels.append(None)
            continue
        # level slices keep the index's PAD tail (PAD_KEY rows pack to
        # the table sentinel, above every real query)
        lvl = slice(index.level_offsets[lv],
                    index.level_offsets[lv] + index.level_pad[lv])
        levels.append((index.keys[lvl], index.starts[lvl], index.ends[lvl]))
    return (
        levels, pqe_k, pqe_v, pqs_k, pqs_v, c_bj2, c_bj1, c_qe, c_qs,
        ord_qe, ord_qs, m_pad,
    )


@jax.jit
def _level_rank_pair(k_l, s_l, e_l, pqe_k, pqe_v, pqs_k, pqs_v,
                     c_bj2, c_bj1, c_qe, c_qs):
    """One level's (ub, lb) rank pair over the packed domains."""
    a_s = _pack_view(k_l, s_l, c_bj2, _PROBE_PAD)
    q_e = _pack_view(pqe_k, pqe_v, c_qe, _BUILD_PAD)
    a_e = _pack_view(k_l, e_l, c_bj1, _PROBE_PAD)
    q_s = _pack_view(pqs_k, pqs_v, c_qs, _BUILD_PAD)
    ub = _rank_sorted(a_s, q_e, strict=False)
    lb = _rank_sorted(a_e, q_s, strict=True)
    return ub, lb


@jax.jit
def _scatter_bounds(ub_stack, lb_stack, ord_qe, ord_qs):
    """Scatter per-pass sorted-order ranks back to probe row order.

    PAD slots of the orders carry the out-of-bounds index m_pad and drop;
    every real probe row appears exactly once per view, so the scatter
    indices are disjoint (mode='drop' discards only the PAD slots)."""
    L, m_pad = ub_stack.shape
    z = jnp.zeros((m_pad, L), jnp.int32)
    ub = z.at[ord_qe].set(ub_stack.T, mode="drop", unique_indices=True)
    lb = z.at[ord_qs].set(lb_stack.T, mode="drop", unique_indices=True)
    return lb.T, ub.T


def merge_level_bounds(plan):
    """Run the plan: per-level [lb, ub) emission bounds, [L, m_pad] int32
    in PROBE ROW order — drop-in for ops/interval_join.overlap_bounds."""
    (levels, pqe_k, pqe_v, pqs_k, pqs_v, c_bj2, c_bj1, c_qe, c_qs,
     ord_qe, ord_qs, m_pad) = plan
    ubs, lbs = [], []
    zero = None
    for lv in levels:
        if lv is None:
            if zero is None:
                zero = jnp.zeros((m_pad,), jnp.int32)
            ubs.append(zero)
            lbs.append(zero)
            continue
        ub, lb = _level_rank_pair(
            *lv, pqe_k, pqe_v, pqs_k, pqs_v, c_bj2, c_bj1, c_qe, c_qs
        )
        ubs.append(ub)
        lbs.append(lb)
    return _scatter_bounds(jnp.stack(ubs), jnp.stack(lbs), ord_qe, ord_qs)
