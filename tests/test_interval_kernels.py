"""Core kernel tests: level index invariants, counts, pairs, nearest.

Randomized cross-checks against brute-force NumPy oracles — the same
oracle pattern the reference uses (stock join output as ground truth,
reference tests/integration_test.rs:67-118).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sequila_tpu.ops.interval_index import build_interval_index, assign_levels
from sequila_tpu.ops.interval_join import (
    count_matches,
    materialize_pairs,
    nearest_match,
)
from sequila_tpu.ops.oracle import oracle_counts, oracle_nearest, oracle_pairs
from sequila_tpu.ops.ranks import np_rank_lex, rank_lex_sort


def random_tables(rng, n, m, num_keys=4, coord_range=10_000, max_len=300):
    bk = rng.integers(0, num_keys, n).astype(np.int32)
    bs = rng.integers(0, coord_range, n).astype(np.int32)
    be = bs + rng.integers(0, max_len, n).astype(np.int32)
    qk = rng.integers(0, num_keys + 1, m).astype(np.int32)  # +1: absent keys
    qs = rng.integers(0, coord_range, m).astype(np.int32)
    qe = qs + rng.integers(0, max_len, m).astype(np.int32)
    return bk, bs, be, qk, qs, qe


class TestRanks:
    def test_rank_lex_sort_matches_numpy(self, rng):
        for side in ("left", "right"):
            b1 = rng.integers(0, 5, 200).astype(np.int32)
            b2 = rng.integers(0, 50, 200).astype(np.int32)
            q1 = rng.integers(0, 6, 77).astype(np.int32)
            q2 = rng.integers(0, 55, 77).astype(np.int32)
            got = np.asarray(
                rank_lex_sort(
                    (jnp.asarray(b1), jnp.asarray(b2)),
                    (jnp.asarray(q1), jnp.asarray(q2)),
                    side=side,
                )
            )
            want = np_rank_lex((b1, b2), (q1, q2), side=side)
            np.testing.assert_array_equal(got, want)


class TestLevelIndex:
    def test_level_invariant(self, rng):
        """Within each (level, key) segment ends must be non-decreasing."""
        bk, bs, be, *_ = random_tables(rng, 500, 0)
        idx = build_interval_index(bk, bs, be)
        K = np.asarray(idx.keys)
        S = np.asarray(idx.starts)
        E = np.asarray(idx.ends)
        L = np.asarray(idx.levels)
        for lv in range(idx.num_levels):
            off, sz = idx.level_offsets[lv], idx.level_sizes[lv]
            k, s, e = K[off : off + sz], S[off : off + sz], E[off : off + sz]
            for key in np.unique(k):
                seg = np.nonzero(k == key)[0]
                assert np.all(np.diff(s[seg]) >= 0), "starts must ascend"
                assert np.all(np.diff(e[seg]) >= 0), "ends must ascend"
        # every real row appears exactly once
        P = np.asarray(idx.pos)
        real = P[P >= 0]
        assert sorted(real.tolist()) == list(range(500))
        assert L.shape == K.shape

    def test_nested_intervals_peel_deep(self):
        """Fully nested intervals -> one level each, still exact."""
        n = 20
        bk = np.zeros(n, np.int32)
        bs = np.arange(n, dtype=np.int32)
        be = (100 - np.arange(n)).astype(np.int32)
        idx = build_interval_index(bk, bs, be)
        assert idx.num_levels == n
        counts = np.asarray(
            count_matches(
                idx,
                jnp.asarray([0], jnp.int32).repeat(1),
                jnp.asarray([50], jnp.int32),
                jnp.asarray([50], jnp.int32),
            )
        )
        assert counts[0] == n

    def test_assign_levels_terminates_on_duplicates(self):
        bk = np.zeros(100, np.int32)
        bs = np.full(100, 7, np.int32)
        be = np.full(100, 9, np.int32)
        order, levels = assign_levels(bk, bs, be)
        assert levels.max() == 0  # equal ends are non-decreasing: one level


@pytest.mark.parametrize("method", ["sort", "bsearch"])
class TestCounts:
    def test_random_counts(self, rng, method):
        bk, bs, be, qk, qs, qe = random_tables(rng, 800, 300)
        idx = build_interval_index(bk, bs, be)
        got = np.asarray(
            count_matches(
                idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method
            )
        )
        np.testing.assert_array_equal(got, oracle_counts(bk, bs, be, qk, qs, qe))

    def test_point_and_degenerate_queries(self, rng, method):
        bk, bs, be, *_ = random_tables(rng, 300, 0)
        idx = build_interval_index(bk, bs, be)
        qk = np.zeros(4, np.int32)
        qs = np.array([50, 100, 0, 60], np.int32)
        qe = np.array([50, 100, 0, 40], np.int32)  # last: qe < qs (degenerate)
        got = np.asarray(
            count_matches(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method)
        )
        want = oracle_counts(bk, bs, be, qk, qs, qe)
        np.testing.assert_array_equal(got, want)

    def test_empty_build(self, rng, method):
        idx = build_interval_index(
            np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int32)
        )
        got = np.asarray(
            count_matches(
                idx,
                jnp.asarray([0, 1], jnp.int32),
                jnp.asarray([1, 2], jnp.int32),
                jnp.asarray([3, 4], jnp.int32),
                method,
            )
        )
        np.testing.assert_array_equal(got, [0, 0])


@pytest.mark.parametrize("method", ["sort", "bsearch", "window"])
class TestPairs:
    def test_random_pairs_exact(self, rng, method):
        bk, bs, be, qk, qs, qe = random_tables(rng, 400, 200)
        idx = build_interval_index(bk, bs, be)
        b_rows, p_rows, total = materialize_pairs(
            idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method
        )
        ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
        assert total == len(ob)
        got = sorted(zip(p_rows.tolist(), b_rows.tolist()))
        want = sorted(zip(op.tolist(), ob.tolist()))
        assert got == want

    def test_dense_pairs_bounds_expansion(self, rng, method):
        # Dense overlaps: total matches >> 2*L*m, which flips
        # materialize_pairs onto the host bounds-expansion path (the
        # sparse tests above stay on emit_pairs) — both must agree with
        # the oracle bit-for-bit.
        n, m = 400, 100
        bk = (np.arange(n, dtype=np.int32) % 2).astype(np.int32)
        bs = rng.integers(0, 50, n).astype(np.int32)
        be = bs + rng.integers(0, 400, n).astype(np.int32)
        qk = (np.arange(m, dtype=np.int32) % 2).astype(np.int32)
        qs = rng.integers(0, 100, m).astype(np.int32)
        qe = qs + rng.integers(0, 200, m).astype(np.int32)
        idx = build_interval_index(bk, bs, be)
        b_rows, p_rows, total = materialize_pairs(
            idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method
        )
        ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
        assert total == len(ob)
        if method != "window":
            # confirm the dense case really crossed the threshold
            assert total > 2 * idx.num_levels * len(qk)
        got = sorted(zip(p_rows.tolist(), b_rows.tolist()))
        want = sorted(zip(op.tolist(), ob.tolist()))
        assert got == want

    def test_single_level_long_runs_bounds_path(self, rng, method):
        # One level (starts AND ends ascending), every probe hits a run of
        # ~11 intervals: nnz == m so 2*nnz >= 2*L*m, while 2*L*m < total —
        # exercises the raw [L,m] bounds-expansion branch.
        n, m = 600, 100
        bk = np.zeros(n, np.int32)
        bs = np.arange(n, dtype=np.int32)
        be = bs + 10
        qk = np.zeros(m, np.int32)
        qs = rng.integers(0, n - 20, m).astype(np.int32)
        qe = qs + 5
        idx = build_interval_index(bk, bs, be)
        b_rows, p_rows, total = materialize_pairs(
            idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method
        )
        ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
        assert total == len(ob)
        got = sorted(zip(p_rows.tolist(), b_rows.tolist()))
        want = sorted(zip(op.tolist(), ob.tolist()))
        assert got == want

    def test_run_length_over_uint16_unpacked(self, rng, method):
        # One level-run of 70 000 matches: maxrun >= 2^16 disables the
        # uint16 run-length packing, exercising the full-width transfer
        # branch of the compact-runs path.
        n = 70_000
        bk = np.zeros(n, np.int32)
        bs = np.arange(n, dtype=np.int32)
        be = bs + 200_000  # ends ascend with starts -> a single level
        # 1 probe with the giant run, a few small-run probes, and a
        # majority of no-match probes so 2*nnz < min(total, 2*L*m_pad)
        # keeps this on the compact-runs path (asserted below).
        m = 64
        qk = np.zeros(m, np.int32)
        qs = np.full(m, 500_000, np.int32)  # default: no matches
        qe = qs + 5
        qs[0], qe[0] = 0, 250_000  # the >2^16 run
        qs[1:9] = np.arange(8, dtype=np.int32) * 10
        qe[1:9] = qs[1:9] + 5
        idx = build_interval_index(bk, bs, be)
        b_rows, p_rows, total = materialize_pairs(
            idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), method
        )
        ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
        assert total == len(ob) and total > (1 << 16)
        got = sorted(zip(p_rows.tolist(), b_rows.tolist()))
        want = sorted(zip(op.tolist(), ob.tolist()))
        assert got == want

    def test_no_matches(self, rng, method):
        bk = np.zeros(10, np.int32)
        bs = np.arange(10, dtype=np.int32) * 100
        be = bs + 5
        idx = build_interval_index(bk, bs, be)
        _, _, total = materialize_pairs(
            idx,
            jnp.asarray([0], jnp.int32),
            jnp.asarray([50], jnp.int32),
            jnp.asarray([60], jnp.int32),
            method,
        )
        assert total == 0


class TestNearest:
    def test_random_nearest(self, rng):
        bk, bs, be, qk, qs, qe = random_tables(rng, 300, 200, num_keys=3)
        idx = build_interval_index(bk, bs, be)
        got = np.asarray(
            nearest_match(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe))
        )
        want = oracle_nearest(bk, bs, be, qk, qs, qe)
        for i in range(len(qk)):
            if want[i] == -1:
                assert got[i] == -1, f"row {i}: expected NULL"
                continue
            g = got[i]
            assert g >= 0
            assert bk[g] == qk[i]
            w = want[i]
            overlap_w = bs[w] <= qe[i] and be[w] >= qs[i]
            overlap_g = bs[g] <= qe[i] and be[g] >= qs[i]
            assert overlap_g == overlap_w, f"row {i}: overlap class mismatch"
            if not overlap_w:
                def dist(j):
                    if be[j] < qs[i]:
                        return qs[i] - be[j]
                    return bs[j] - qe[i]
                assert dist(g) == dist(w), f"row {i}: distance mismatch"

    def test_reference_nearest_fixture(self):
        """The reference's nearest test (integration_test.rs:352-399).

        Build side a=(5,10) keyed by (contig,strand); probes from b.  Key
        codes here stand in for the (contig,strand) pairs.
        """
        bk = np.array([0], np.int32)  # ('a','s')
        bs = np.array([5], np.int32)
        be = np.array([10], np.int32)
        idx = build_interval_index(bk, bs, be)
        # probes: ('a','s',11,13), ('a','s',20,21), ('a','x',0,1), ('b','s',1,2)
        qk = np.array([0, 0, 1, 2], np.int32)
        # strict ops (< / >) normalize to end-inclusive via -1 on ends:
        # a.start < b.end AND a.end > b.start  ->  probe interval
        # [start+1, end-1] relative to build [5,10]
        qs = np.array([11 + 1, 20 + 1, 0 + 1, 1 + 1], np.int32)
        qe = np.array([13 - 1, 21 - 1, 1 - 1, 2 - 1], np.int32)
        got = np.asarray(nearest_match(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe)))
        # rows 0,1: key present, no overlap -> nearest = build row 0
        # rows 2,3: key absent -> NULL
        np.testing.assert_array_equal(got, [0, 0, -1, -1])


class TestBitsCount:
    def test_bits_matches_oracle_nondegenerate(self, rng):
        bk, bs, be, qk, qs, qe = random_tables(rng, 600, 400)
        idx = build_interval_index(bk, bs, be)
        got = np.asarray(
            count_matches(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "bits")
        )
        np.testing.assert_array_equal(got, oracle_counts(bk, bs, be, qk, qs, qe))

    def test_bits_matches_levels_on_deep_nesting(self, rng):
        # fully nested: BITS needs no level structure, stays O(1) ranks
        n = 50
        bk = np.zeros(n, np.int32)
        bs = np.arange(n, dtype=np.int32)
        be = (200 - np.arange(n)).astype(np.int32)
        idx = build_interval_index(bk, bs, be)
        qk = np.zeros(5, np.int32)
        qs = np.array([0, 60, 100, 150, 190], np.int32)
        qe = qs + 5
        got = np.asarray(
            count_matches(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "bits")
        )
        np.testing.assert_array_equal(got, oracle_counts(bk, bs, be, qk, qs, qe))

    def test_degenerate_stabbing_rows_need_level_path(self):
        """qs > qe can still match (stabbing a long interval): the level
        path is exact there; BITS intentionally zeroes such rows."""
        bk = np.array([0], np.int32)
        bs = np.array([0], np.int32)
        be = np.array([100], np.int32)
        idx = build_interval_index(bk, bs, be)
        qk = np.array([0], np.int32)
        qs = np.array([50], np.int32)
        qe = np.array([10], np.int32)  # degenerate, but [0,100] matches
        level = np.asarray(
            count_matches(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "sort")
        )
        bits = np.asarray(
            count_matches(idx, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "bits")
        )
        assert level[0] == 1
        assert bits[0] == 0


class TestStreamSortedCount:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_stream_count_matches_oracle(self, rng, deltas):
        """The sort-free cached-view count path (the packed-u32 merge
        count) == brute force, incl. the planner's ±1 strict-op deltas."""
        import pyarrow as pa

        from sequila_tpu.config import Algorithm
        from sequila_tpu.exec.context import ExecContext
        from sequila_tpu.config import SequilaConfig
        from sequila_tpu.exec.joins.interval_join import IntervalJoinExec
        from sequila_tpu.exec.plan import ScanExec
        from sequila_tpu.models.table import Table
        from sequila_tpu.planner.expr import BinaryExpr, Column, Literal
        from sequila_tpu.planner.intervals import ColInterval, ColIntervals

        d_bs, d_be, d_qs, d_qe = deltas
        n, m = 400, 600
        lts = rng.integers(0, 5000, n).astype(np.int64)
        rts = rng.integers(0, 8000, m).astype(np.int64)
        lt = Table(pa.table({
            "contig": [f"c{int(k)}" for k in rng.integers(0, 5, n)],
            "s": lts,
            "e": lts + rng.integers(2, 3000, n),
        }))
        rt = Table(pa.table({
            "contig": [f"c{int(k)}" for k in rng.integers(0, 6, m)],
            "s": rts,
            "e": rts + rng.integers(2, 3000, m),
        }))

        def bound(idx, d):
            col = Column("x", idx)
            if d == 0:
                return col
            return BinaryExpr(col, "+" if d > 0 else "-", Literal(abs(d)))

        join = IntervalJoinExec(
            ScanExec("l", lt), ScanExec("r", rt),
            on=[(Column("contig", 0), Column("contig", 0))],
            filter_=None,
            intervals=ColIntervals(
                ColInterval(bound(1, d_bs), bound(2, d_be)),
                ColInterval(bound(1, d_qs), bound(2, d_qe)),
            ),
            algorithm=Algorithm.COITREES,
        )
        ctx = ExecContext(SequilaConfig())
        got = join._merge_sorted_count(ctx, lt, rt)
        assert got is not None, "merge backend must engage for this shape"
        lk = lt.column_np("contig")
        ls = lt.column_np("s") + d_bs
        le = lt.column_np("e") + d_be
        rk = rt.column_np("contig")
        rs = rt.column_np("s") + d_qs
        re = rt.column_np("e") + d_qe
        want = sum(
            int(((lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])).sum())
            for i in range(m)
        )
        assert got == want
