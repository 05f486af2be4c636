"""Regression tests for the round-1 final-review findings.

Each test locks in a specific defect found by adversarial review of the
kernels/planner (bucket-full bsearch/nearest, inverted build intervals,
3-table comma joins, overflow guards, book-ended merges, empty-input
aggregate NULLs).  Reference semantics cited per test.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

from sequila_tpu.ops.interval_index import build_interval_index
from sequila_tpu.ops.interval_join import count_matches
from sequila_tpu.ops.oracle import oracle_counts
from sequila_tpu.session import SessionContext


def _ctx_tables(ctx, lk, ls, le, rk, rs, re):
    ctx.register_table(
        "a",
        pa.table({"contig": [f"c{int(k)}" for k in lk], "s": ls, "e": le}),
    )
    ctx.register_table(
        "b",
        pa.table({"contig": [f"c{int(k)}" for k in rk], "s": rs, "e": re}),
    )


Q = (
    "SELECT count(*) FROM a JOIN b ON a.contig = b.contig "
    "AND a.s <= b.e AND a.e >= b.s"
)


class TestBucketFullPaths:
    """Findings 1+2: level buckets exactly full (no PAD tail) must not
    read one-past-the-end in the bsearch/nearest kernels."""

    def _full_bucket_data(self):
        # 64 rows in one key → bucket(64) == 64: zero padding in level 0
        n = 64
        lk = np.zeros(n, np.int32)
        ls = np.arange(0, 10 * n, 10, dtype=np.int32)
        le = ls + 5
        return lk, ls, le

    def test_bsearch_full_bucket_exact(self):
        lk, ls, le = self._full_bucket_data()
        index = build_interval_index(jnp.asarray(lk), jnp.asarray(ls), jnp.asarray(le))
        # probe past the last interval: must count 0, not clamp-miscount
        qk = jnp.zeros(8, jnp.int32)
        qs = jnp.asarray([10**6, 0, 635, 1, 300, 636, 2**31 - 10, 50], jnp.int32)
        qe = qs + 3
        want = oracle_counts(lk, ls, le, np.zeros(8, np.int32), np.asarray(qs), np.asarray(qe))
        for method in ("bsearch", "sort", "bits"):
            got = np.asarray(count_matches(index, qk, qs, qe, method))
            np.testing.assert_array_equal(got, want, err_msg=method)

    def test_nearest_full_bucket(self):
        from sequila_tpu.ops.interval_join import nearest_match

        lk, ls, le = self._full_bucket_data()
        index = build_interval_index(jnp.asarray(lk), jnp.asarray(ls), jnp.asarray(le))
        # query strictly downstream of every interval: nearest must be the
        # LAST interval (row 63), not garbage from the clamped pad read
        qk = jnp.zeros(2, jnp.int32)
        qs = jnp.asarray([10_000, 633], jnp.int32)
        qe = jnp.asarray([10_005, 634], jnp.int32)
        got = np.asarray(nearest_match(index, qk, qs, qe))
        assert got[0] == 63
        assert got[1] == 63  # end of row 63 is 635 >= ... closest upstream


class TestInvertedBuildIntervals:
    """Finding 3: build intervals with end < start break the BITS subset
    identity (an entry with end < qs AND start > qe subtracts without
    adding).  All count paths must route to an exact method."""

    def _data(self):
        lk = np.array([0, 0, 0], np.int32)
        ls = np.array([100, 500, 900], np.int32)
        le = np.array([50, 510, 890], np.int32)  # rows 0 and 2 inverted
        rk = np.array([0, 0, 0, 0], np.int32)
        rs = np.array([0, 505, 60, 1000], np.int32)
        re = np.array([10, 506, 95, 1100], np.int32)
        return lk, ls, le, rk, rs, re

    def test_kernel_bits_guarded_by_operator(self):
        lk, ls, le, rk, rs, re = self._data()
        want = oracle_counts(lk, ls, le, rk, rs, re)
        # level path is exact even for inverted builds
        index = build_interval_index(jnp.asarray(lk), jnp.asarray(ls), jnp.asarray(le))
        got = np.asarray(
            count_matches(index, jnp.asarray(rk), jnp.asarray(rs), jnp.asarray(re), "sort")
        )
        np.testing.assert_array_equal(got, want)

    def test_host_index_counts(self):
        from sequila_tpu.ops.host_join import HostIntervalIndex

        lk, ls, le, rk, rs, re = self._data()
        idx = HostIntervalIndex(lk, ls, le)
        assert idx.has_inverted
        np.testing.assert_array_equal(
            idx.counts(rk, rs, re), oracle_counts(lk, ls, le, rk, rs, re)
        )

    def test_native_counts(self):
        from sequila_tpu.native.loader import NativeIntervalIndex, available

        if not available():
            pytest.skip("native library unavailable")
        lk, ls, le, rk, rs, re = self._data()
        idx = NativeIntervalIndex(lk, ls, le)
        np.testing.assert_array_equal(
            idx.counts(rk, rs, re), oracle_counts(lk, ls, le, rk, rs, re)
        )

    @pytest.mark.parametrize("host", ["0", "1000000"])
    def test_sql_count_inverted_build(self, host, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", host)
        ctx = SessionContext()
        lk, ls, le, rk, rs, re = self._data()
        _ctx_tables(ctx, lk, ls, le, rk, rs, re)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert ctx.sql(Q).column_np(0)[0] == want

    def test_device_count_rows_inverted(self, monkeypatch):
        # chunked count_rows path with the device kernels (host threshold 0)
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        ctx = SessionContext()
        rng = np.random.default_rng(7)
        n, m = 300, 400
        lk = rng.integers(0, 3, n).astype(np.int32)
        ls = rng.integers(0, 5000, n).astype(np.int32)
        le = ls + rng.integers(-200, 200, n).astype(np.int32)  # some inverted
        assert (le < ls).any()
        rk = rng.integers(0, 3, m).astype(np.int32)
        rs = rng.integers(0, 5000, m).astype(np.int32)
        re = rs + rng.integers(0, 150, m).astype(np.int32)
        _ctx_tables(ctx, lk, ls, le, rk, rs, re)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert ctx.sql(Q).column_np(0)[0] == want


class TestThreeTableCommaJoin:
    """Finding 4: WHERE conjuncts naming the third comma table must wait
    for the join that brings it into scope, not raise PlanError."""

    def _ctx(self):
        ctx = SessionContext()
        ctx.register_table("a", pa.table({"x": [1, 2, 3], "v": [10, 20, 30]}))
        ctx.register_table("b", pa.table({"x": [1, 2, 4], "w": [100, 200, 400]}))
        ctx.register_table("c", pa.table({"x": [1, 3, 4], "u": [7, 8, 9]}))
        return ctx

    def test_three_table_equi_chain(self):
        ctx = self._ctx()
        got = ctx.sql(
            "SELECT count(*) FROM a, b, c WHERE a.x = b.x AND b.x = c.x"
        )
        # x=1 matches in all three; x=2 not in c; others don't chain
        assert got.column_np(0)[0] == 1

    def test_three_table_values(self):
        ctx = self._ctx()
        got = ctx.sql(
            "SELECT a.v, b.w, c.u FROM a, b, c "
            "WHERE a.x = b.x AND b.x = c.x ORDER BY a.v"
        )
        assert got.to_pylist() == [{"v": 10, "w": 100, "u": 7}]

    def test_unknown_column_still_raises(self):
        from sequila_tpu.errors import PlanError

        ctx = self._ctx()
        with pytest.raises(PlanError):
            ctx.sql("SELECT count(*) FROM a, b WHERE a.x = nosuch.y")


class TestMaterializeOverflowGuard:
    """Finding 5: emit totals >= 2^31 must raise a clear error instead of
    wrapping int32 offsets (can't allocate that for real — checked via the
    internal total computation, not an actual 2-billion-row emit)."""

    def test_total64_is_int64(self):
        from sequila_tpu.ops.interval_join import counts_from_bounds

        lb = jnp.zeros((1, 4), jnp.int32)
        ub = jnp.full((1, 4), 2**30, jnp.int32)
        total = int(np.asarray(counts_from_bounds(lb, ub)).astype(np.int64).sum())
        assert total == 4 * 2**30  # would wrap to 0 in int32


class TestMergeBookEnded:
    """Finding 7: end-inclusive intervals [0,10] and [11,20] are adjacent
    (book-ended) and must merge — reference merge semantics."""

    def test_book_ended_merge(self):
        from sequila_tpu.ops.genomic import merge_intervals

        k = np.asarray([0, 0, 0], np.int32)
        s = np.asarray([0, 11, 25], np.int32)
        e = np.asarray([10, 20, 30], np.int32)
        mk, ms, me = merge_intervals(k, s, e)
        assert np.asarray(ms).tolist() == [0, 25]
        assert np.asarray(me).tolist() == [20, 30]

    def test_gap_of_one_does_not_merge(self):
        from sequila_tpu.ops.genomic import merge_intervals

        k = np.asarray([0, 0], np.int32)
        s = np.asarray([0, 12], np.int32)
        e = np.asarray([10, 20], np.int32)
        mk, ms, me = merge_intervals(k, s, e)
        assert np.asarray(ms).tolist() == [0, 12]


class TestEmptyAggregatesNull:
    """Finding 10: sum/min/max/avg over zero rows is SQL NULL, count is 0."""

    def test_empty_input_aggregates(self):
        ctx = SessionContext()
        ctx.register_table("t", pa.table({"x": pa.array([], type=pa.int64())}))
        got = ctx.sql(
            "SELECT count(*), sum(x), min(x), max(x), avg(x) FROM t"
        ).to_pylist()[0]
        vals = list(got.values())
        assert vals[0] == 0
        assert vals[1] is None
        assert vals[2] is None
        assert vals[3] is None
        assert vals[4] is None

    def test_filtered_to_empty(self):
        ctx = SessionContext()
        ctx.register_table("t", pa.table({"x": [1, 2, 3]}))
        got = ctx.sql("SELECT sum(x), count(x) FROM t WHERE x > 100").to_pylist()[0]
        vals = list(got.values())
        assert vals[0] is None
        assert vals[1] == 0


class TestGroupedCountReuse:
    """Finding 9: grouped interval count must not re-execute the probe
    subplan (correctness: same table object; perf: no double scan)."""

    def test_grouped_count_correct(self):
        ctx = SessionContext()
        rng = np.random.default_rng(3)
        n, m = 60, 80
        lk = rng.integers(0, 3, n).astype(np.int32)
        ls = rng.integers(0, 2000, n).astype(np.int32)
        le = ls + rng.integers(0, 100, n).astype(np.int32)
        rk = rng.integers(0, 3, m).astype(np.int32)
        rs = rng.integers(0, 2000, m).astype(np.int32)
        re = rs + rng.integers(0, 100, m).astype(np.int32)
        _ctx_tables(ctx, lk, ls, le, rk, rs, re)
        res = ctx.sql(
            "SELECT b.contig, count(*) FROM a JOIN b ON a.contig = b.contig "
            "AND a.s <= b.e AND a.e >= b.s GROUP BY b.contig ORDER BY b.contig"
        )
        counts = oracle_counts(lk, ls, le, rk, rs, re)
        want = {}
        for key, c in zip(rk, counts):
            want[f"c{int(key)}"] = want.get(f"c{int(key)}", 0) + int(c)
        want = {k: v for k, v in sorted(want.items()) if v > 0}
        assert list(res.column_np(0)) == list(want.keys())
        assert list(res.column_np(1)) == list(want.values())


class TestAggregateNullSkipping:
    """SQL aggregates skip NULLs: count(col) counts non-null rows only,
    sum/avg/min/max ignore NULLs, and all-NULL groups yield NULL."""

    def _ctx(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table(
            "n",
            pa.table({"g": ["a", "a", "b"],
                      "v": pa.array([1, None, None], type=pa.int64())}),
        )
        return c

    def test_global_aggregates_skip_nulls(self):
        got = self._ctx().sql(
            "SELECT count(*), count(v), sum(v), avg(v), min(v), max(v) FROM n"
        ).to_pylist()[0]
        assert list(got.values()) == [3, 1, 1.0, 1.0, 1.0, 1.0]

    def test_grouped_all_null_group_is_null(self):
        got = self._ctx().sql(
            "SELECT g, count(v), sum(v), min(v) FROM n GROUP BY g ORDER BY g"
        ).to_pylist()
        assert got == [
            {"g": "a", "count(v)": 1, "sum(v)": 1.0, "min(v)": 1.0},
            {"g": "b", "count(v)": 0, "sum(v)": None, "min(v)": None},
        ]

    def test_count_distinct_skips_nulls(self):
        got = self._ctx().sql("SELECT count(DISTINCT v) FROM n").to_pylist()[0]
        assert list(got.values()) == [1]


class TestSqlReviewRound2:
    """Round-2 review findings on the SQL layer (code-review of the SQL
    surface expansion): frame clamping, nullable CAST, OVER NULLS
    placement, Kleene NOT, negative lag offsets, string min/max with
    NULLs, CASE over aggregates, DESC NULLS default."""

    def _ctx(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table(
            "t",
            pa.table({"id": list(range(5)),
                      "x": pa.array([1.7, None, 3.0, 4.0, 5.0], pa.float64())}),
        )
        return c

    def test_following_only_frame_no_crash(self):
        got = self._ctx().sql(
            "SELECT id, sum(x) OVER (ORDER BY id ROWS BETWEEN 2 FOLLOWING "
            "AND 3 FOLLOWING) AS s FROM t ORDER BY id"
        ).to_pylist()
        vals = [r["s"] for r in got]
        assert vals[3] is None and vals[4] is None
        assert vals[:3] == pytest.approx([7.0, 9.0, 5.0])

    def test_cast_int_nullable_truncates(self):
        got = self._ctx().sql("SELECT CAST(x AS INTEGER) AS i FROM t").column_np(0)
        assert got[0] == 1.0 and got[2] == 3.0  # truncated, not 1.7

    def test_over_nulls_first(self):
        got = self._ctx().sql(
            "SELECT id, row_number() OVER (ORDER BY x NULLS FIRST) AS rn "
            "FROM t ORDER BY id"
        ).to_pylist()
        assert got[1]["rn"] == 1  # NULL row ranks first

    def test_not_comparison_excludes_null(self):
        got = self._ctx().sql(
            "SELECT id FROM t WHERE NOT (x = 3) ORDER BY id"
        ).to_pylist_column(0)
        assert got == [0, 3, 4]  # NULL row excluded (UNKNOWN)

    def test_negative_lag_offset_rejected(self):
        from sequila_tpu.errors import PlanError

        with pytest.raises(PlanError, match="non-negative"):
            self._ctx().sql("SELECT lag(id, -1) OVER (ORDER BY id) FROM t")

    def test_string_min_max_with_nulls(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table(
            "s", pa.table({"g": ["a", "a", "b"], "v": ["x", None, None]})
        )
        got = c.sql("SELECT g, min(v), max(v) FROM s GROUP BY g ORDER BY g").to_pylist()
        assert got == [
            {"g": "a", "min(v)": "x", "max(v)": "x"},
            {"g": "b", "min(v)": None, "max(v)": None},
        ]
        got2 = c.sql("SELECT min(v) OVER (PARTITION BY g) FROM s").to_pylist()
        assert [list(r.values())[0] for r in got2] == ["x", "x", None]

    def test_case_over_aggregate(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("q", pa.table({"g": ["a", "a", "b"], "v": [1, 2, 5]}))
        got = c.sql(
            "SELECT g, CASE WHEN count(*) > 1 THEN 'big' ELSE 'small' END AS z "
            "FROM q GROUP BY g ORDER BY g"
        ).to_pylist()
        assert got == [{"g": "a", "z": "big"}, {"g": "b", "z": "small"}]

    def test_desc_defaults_nulls_first(self):
        got = self._ctx().sql(
            "SELECT id FROM t ORDER BY x DESC"
        ).to_pylist_column(0)
        assert got == [1, 4, 3, 2, 0]  # NULL first on DESC (DataFusion)


class TestReviewRound4:
    """Findings from the review of the RANGE/ineq/tile/DDL batch."""

    def test_range_null_keys_match_sqlite(self):
        import sqlite3

        from sequila_tpu.session import SessionContext

        rows = [("a", 1, 1.0), ("a", None, 9.0), ("b", 1, 2.0),
                ("b", 2, 3.0), ("b", 100, 5.0), ("b", None, 4.0)]
        c = SessionContext()
        c.register_table(
            "t",
            pa.table({"g": [r[0] for r in rows],
                      "k": pa.array([r[1] for r in rows], pa.int64()),
                      "v": [r[2] for r in rows], "id": list(range(6))}),
        )
        con = sqlite3.connect(":memory:")
        con.execute("CREATE TABLE t (g TEXT, k INT, v REAL, id INT)")
        con.executemany(
            "INSERT INTO t VALUES (?,?,?,?)",
            [(r[0], r[1], r[2], i) for i, r in enumerate(rows)],
        )
        for q in [
            "SELECT id, sum(v) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS s FROM t ORDER BY id",
            "SELECT id, sum(v) OVER (PARTITION BY g ORDER BY k NULLS FIRST RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS s FROM t ORDER BY id",
            "SELECT id, sum(v) OVER (ORDER BY k RANGE BETWEEN 0.5 PRECEDING AND 1.5 FOLLOWING) AS s FROM t ORDER BY id",
        ]:
            mine = [tuple(r.values()) for r in c.sql(q).to_pylist()]
            assert mine == con.execute(q).fetchall(), q

    def test_tile_int32_overflow_hard_error(self):
        from sequila_tpu import dataframe as gdf

        with pytest.raises(ValueError, match="int32"):
            gdf.tile({"c": (2**31, 2**31 + 10)}, window=5)

    def test_distinct_ineq_correlation_rejected(self):
        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("o", pa.table({"oid": [1], "ts": [1], "amt": [1.0]}))
        with pytest.raises(PlanError, match="DISTINCT"):
            c.sql(
                "SELECT oid FROM o WHERE amt > "
                "(SELECT avg(DISTINCT amt) FROM o o2 WHERE o2.ts < o.ts)"
            )

    def test_string_ineq_key_clean_error(self):
        from sequila_tpu.errors import ExecutionError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("o", pa.table({"oid": [1], "nm": ["a"], "amt": [1.0]}))
        with pytest.raises(ExecutionError, match="numeric"):
            c.sql(
                "SELECT oid FROM o WHERE amt > "
                "(SELECT avg(amt) FROM o o2 WHERE o2.nm < o.nm)"
            )

    def test_fractional_rows_offset_rejected_range_ok(self):
        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("o", pa.table({"ts": [1, 2], "amt": [1.0, 2.0]}))
        with pytest.raises(PlanError, match="integers"):
            c.sql(
                "SELECT sum(amt) OVER (ORDER BY ts ROWS BETWEEN 2.5 "
                "PRECEDING AND CURRENT ROW) FROM o"
            )
        got = c.sql(
            "SELECT sum(amt) OVER (ORDER BY ts RANGE BETWEEN 0.5 "
            "PRECEDING AND CURRENT ROW) AS s FROM o ORDER BY ts"
        ).to_pylist_column(0)
        assert got == [1.0, 2.0]

    def test_range_nonnumeric_key_clean_error(self):
        from sequila_tpu.errors import ExecutionError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("o", pa.table({"g": ["a"], "v": [1.0]}))
        with pytest.raises(ExecutionError, match="numeric ORDER BY"):
            c.sql(
                "SELECT sum(v) OVER (ORDER BY g RANGE BETWEEN 1 "
                "PRECEDING AND CURRENT ROW) FROM o"
            )


class TestReviewRound5:
    """Final holistic review of the round: UNION OFFSET, SQL arithmetic,
    inverted-build coverage, count(NULL), nearest tie parity, etc."""

    def test_union_trailing_offset(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("a", pa.table({"x": [1, 2, 3]}))
        c.register_table("b", pa.table({"x": [4, 5, 6]}))
        got = c.sql(
            "SELECT x FROM a UNION ALL SELECT x FROM b LIMIT 4 OFFSET 2"
        ).to_pylist_column(0)
        assert got == [3, 4, 5, 6]

    def test_union_order_nulls_first(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("u", pa.table({"x": pa.array([3, None, 1], pa.int64())}))
        got = c.sql(
            "SELECT x FROM u UNION ALL SELECT x FROM u WHERE x = 1 "
            "ORDER BY x NULLS FIRST"
        ).to_pylist_column(0)
        assert got == [None, 1, 1, 3]

    def test_integer_division_truncates(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("t", pa.table({"x": [-7, 7]}))
        got = c.sql("SELECT x / 2, x % 2 FROM t").to_pylist()
        assert got == [{"x / 2": -3, "x % 2": -1}, {"x / 2": 3, "x % 2": 1}]

    def test_object_arith_null_propagates(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("t", pa.table({"x": [3, -7]}))
        got = c.sql("SELECT nullif(x, 3) + 1 AS y FROM t WHERE x = -7")
        assert got.to_pylist_column(0) == [-6.0]
        # the nulled row doesn't crash and compares as UNKNOWN
        assert c.sql("SELECT x FROM t WHERE nullif(x, 3) + 1 > 0").num_rows == 0

    def test_coverage_inverted_build(self):
        from sequila_tpu import dataframe as gdf
        from sequila_tpu.models.table import Table

        b = Table(pa.table({"contig": ["c", "c"], "pos_start": [10, 1],
                            "pos_end": [5, 20]}))
        q = Table(pa.table({"contig": ["c"], "pos_start": [6], "pos_end": [8]}))
        row = gdf.coverage(q, b).to_pylist()[0]
        assert row["count"] == 1 and row["bases"] == 2
        co = gdf.count_overlaps(q, b).to_pylist()[0]
        assert co["count"] == 1

    def test_count_null_literal_is_zero(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("t", pa.table({"x": [1, 2, 3]}))
        got = c.sql("SELECT count(NULL), count(1), count(*) FROM t").to_pylist()[0]
        assert list(got.values()) == [0, 3, 3]

    def test_offset_directly_after_table(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("t", pa.table({"x": [1, 2, 3]}))
        assert c.sql("SELECT x FROM t OFFSET 1").to_pylist_column(0) == [2, 3]

    def test_nearest_tie_break_host_device_parity(self, monkeypatch):
        from sequila_tpu import dataframe as gdf
        from sequila_tpu.models.table import Table

        b = Table(pa.table({"contig": ["c", "c"], "pos_start": [5, 5],
                            "pos_end": [20, 10], "name": ["long", "short"]}))
        q = Table(pa.table({"contig": ["c"], "pos_start": [7], "pos_end": [8]}))
        outs = []
        for thr in ("0", "65536"):
            monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", thr)
            outs.append(gdf.nearest(q, b).to_pylist())
        assert outs[0] == outs[1]
        assert outs[0][0]["name"] == "short"  # smallest-end overlap wins

    def test_ragged_create_values_rejected(self):
        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        with pytest.raises(PlanError, match="row 2"):
            c.sql("CREATE TABLE r (a INT, b INT) AS VALUES (1, 2), (3)")


def test_nullable_int_division_stays_integer():
    """INT columns with NULLs ride as float arrays (NaN = NULL); division
    must still truncate like integer division (17/3 = 5, not 5.67),
    while genuine float columns keep float division."""
    from sequila_tpu.session import SessionContext

    c = SessionContext()
    c.register_table(
        "t", pa.table({"x": pa.array([17, None, -7], pa.int64())})
    )
    r = c.sql("SELECT x / 3 AS d FROM t WHERE x IS NOT NULL ORDER BY x").to_pylist()
    assert [row["d"] for row in r] == [-2.0, 5.0]
    c.register_table("f", pa.table({"v": [5.0]}))
    assert c.sql("SELECT v / 2 FROM f").to_pylist() == [{"v / 2": 2.5}]


class TestEmitGuards:
    """Round-1 VERDICT finding: the >=2^31-candidate guard on the Lapper
    window path raised NameError (ExecutionError was only imported inside
    materialize_pairs).  Trip both guards with a lowered module limit."""

    def _data(self):
        lk = np.zeros(32, np.int32)
        ls = np.arange(32, dtype=np.int32)
        le = ls + 100  # heavily overlapping: every probe hits many builds
        qk = np.zeros(16, np.int32)
        qs = np.full(16, 10, np.int32)
        qe = np.full(16, 50, np.int32)
        return lk, ls, le, qk, qs, qe

    def test_window_guard_raises_execution_error(self, monkeypatch):
        import sequila_tpu.ops.interval_join as ij
        from sequila_tpu.errors import ExecutionError

        lk, ls, le, qk, qs, qe = self._data()
        index = build_interval_index(lk, ls, le)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="candidates"):
            ij.materialize_pairs_window(
                index, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe)
            )

    def test_sort_emit_guard_raises_execution_error(self, monkeypatch):
        import sequila_tpu.ops.interval_join as ij
        from sequila_tpu.errors import ExecutionError

        lk, ls, le, qk, qs, qe = self._data()
        index = build_interval_index(lk, ls, le)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="pairs"):
            ij.materialize_pairs(
                index, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "sort"
            )


# ---------------------------------------------------------------------------
# Round-2 review findings
# ---------------------------------------------------------------------------


class TestSubtractEmptyB:
    """Round-2 finding: vectorized subtract_intervals crashed with
    IndexError when the b side was empty (np.where evaluates both
    branches; me[0] on a size-0 array).  The old loop returned a
    unchanged."""

    def test_genomic_subtract_empty_b(self):
        from sequila_tpu.ops import genomic

        k, s, e = genomic.subtract_intervals(
            np.array([0, 1], np.int32), np.array([5, 7], np.int32),
            np.array([20, 30], np.int32),
            np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int32),
        )
        assert k.tolist() == [0, 1]
        assert s.tolist() == [5, 7]
        assert e.tolist() == [20, 30]

    def test_dataframe_subtract_empty_b(self):
        import sequila_tpu.dataframe as gdf
        from sequila_tpu.models.table import Table

        a = Table(pa.table({
            "contig": ["chr1", "chr2"], "pos_start": [5, 10], "pos_end": [20, 30],
        }))
        b = Table(a.arrow.slice(0, 0))
        out = gdf.subtract(a, b)
        assert out.column_np("pos_start").tolist() == [5, 10]
        assert out.column_np("pos_end").tolist() == [20, 30]

    def test_complement_key_with_no_data(self):
        from sequila_tpu.ops import genomic

        k, s, e = genomic.complement_intervals(
            np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int32),
            {3: (0, 99)},
        )
        assert k.tolist() == [3]
        assert s.tolist() == [0]
        assert e.tolist() == [99]


class TestClosestKTieBreak:
    """Round-2 finding: the upstream k-ring walked the stable (key,end)
    lexsort backward, so equal-end ties surfaced the LARGEST build row
    and the documented 'then smallest build row' tie-break (and parity
    with _closest_k_scan) was violated."""

    def _index(self):
        lk = np.zeros(3, np.int32)
        ls = np.array([1, 2, 3], np.int32)
        le = np.full(3, 10, np.int32)  # three rows tie on (key, end)
        return build_interval_index(lk, ls, le, to_device=np.asarray)

    def test_upstream_tie_returns_smallest_row(self):
        from sequila_tpu.ops import genomic

        index = self._index()
        qk = np.zeros(1, np.int32)
        qs = np.array([20], np.int32)
        qe = np.array([25], np.int32)
        rows, dists = genomic.closest_k(index, qk, qs, qe, k=2)
        assert rows[0].tolist() == [0, 1]
        assert dists[0].tolist() == [10, 10]

    def test_vectorized_matches_scan_on_ties(self):
        from sequila_tpu.ops import genomic
        from sequila_tpu.ops.genomic import _closest_k_scan

        index = self._index()
        qk = np.zeros(2, np.int32)
        qs = np.array([20, 20], np.int32)
        qe = np.array([25, 25], np.int32)
        r_vec, d_vec = genomic.closest_k(index, qk, qs, qe, k=3)
        r_scan, d_scan = _closest_k_scan(index, qk, qs, qe, 3)
        np.testing.assert_array_equal(r_vec, r_scan)
        np.testing.assert_array_equal(d_vec, d_scan)


class TestShardTotalsGuard:
    """Round-2 finding: per-shard emit totals summed on device in int32
    could silently wrap past 2^31; shard_totals now finishes in int64 on
    the host and raises the same guard as the single-chip emit path."""

    def test_partitioned_pairs_raises_over_limit(self, monkeypatch):
        import sequila_tpu.ops.interval_join as ij
        from sequila_tpu.errors import ExecutionError
        from sequila_tpu.parallel.mesh import make_mesh
        from sequila_tpu.parallel.partitioned_join import partitioned_pairs

        mesh = make_mesh(8, part=2)
        lk = np.zeros(64, np.int32)
        ls = np.arange(64, dtype=np.int32)
        le = ls + 1000
        rk = np.zeros(32, np.int32)
        rs = np.full(32, 5, np.int32)
        re = np.full(32, 50, np.int32)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="shard"):
            partitioned_pairs(mesh, lk, ls, le, rk, rs, re)

    def test_shard_totals_dtype_int64(self, rng):
        from sequila_tpu.parallel.mesh import make_mesh
        from sequila_tpu.parallel.partitioned_join import (
            build_partitioned_index,
            partition_probe,
            shard_totals,
        )
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh(8, part=2)
        lk = rng.integers(0, 4, 100).astype(np.int32)
        ls = rng.integers(0, 1000, 100).astype(np.int32)
        le = ls + rng.integers(0, 50, 100).astype(np.int32)
        arrays, meta = build_partitioned_index(lk, ls, le, 2)
        K, S, E, _ = partition_probe(lk, ls, le, 2, 4)
        dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
        didx = [
            dev(arrays[n], P("part", None))
            for n in ("levels", "keys", "starts", "ends")
        ]
        totals = shard_totals(
            mesh, meta, didx,
            dev(K, P("part", "probe", None)),
            dev(S, P("part", "probe", None)),
            dev(E, P("part", "probe", None)),
        )
        assert totals.dtype == np.int64
        from sequila_tpu.ops.oracle import oracle_counts

        want = oracle_counts(lk, ls, le, lk, ls, le).sum()
        assert totals.sum() == want


class TestSatSubI32:
    """Round-2 finding: the device-side window floor used an int64 upcast
    that silently truncates back to int32 (x64 off), wrapping past
    INT32_MIN and dropping matches.  sat_sub_i32 saturates instead."""

    def test_saturates_at_int32_min(self):
        from sequila_tpu.ops.interval_join import sat_sub_i32

        qs = jnp.array([-(2**31) + 10, 100, 0], jnp.int32)
        ml = jnp.asarray(100, jnp.int32)
        out = np.asarray(sat_sub_i32(qs, ml))
        assert out.tolist() == [-(2**31), 0, -100]

    def test_window_pairs_extreme_negative_probe(self):
        import sequila_tpu.ops.interval_join as ij
        from sequila_tpu.ops.oracle import oracle_pairs

        lk = np.zeros(4, np.int32)
        ls = np.array([-(2**31) + 5, -1000, 0, 500], np.int32)
        le = np.array([-(2**31) + 600, -500, 100, 600], np.int32)
        qk = np.zeros(2, np.int32)
        qs = np.array([-(2**31) + 50, -800], np.int32)
        qe = np.array([-(2**31) + 60, -600], np.int32)
        index = build_interval_index(lk, ls, le)
        b, p, n = ij.materialize_pairs_window(
            index, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe)
        )
        got = sorted(zip(p.tolist(), b.tolist()))
        want = sorted(zip(*reversed(oracle_pairs(lk, ls, le, qk, qs, qe))))
        assert got == want


class TestReduceatEmptyGroupTruncation:
    """An empty group whose segment start == nrows must not truncate the
    PRECEDING group's reduceat segment (the clamp-to-nrows-1 bug, found
    by the sqlite differential soak: sum(x) FILTER over a group layout
    where the last group is emptied by the filter)."""

    def test_filter_empties_last_group(self):
        import pyarrow as pa

        from sequila_tpu.session import SessionContext

        c = SessionContext()
        # group d sorts last and is fully removed by the FILTER; group c
        # (the preceding group) must keep BOTH of its rows
        c.register_table(
            "t",
            pa.table(
                {
                    "g": ["c", "d", "c", "a"],
                    "x": pa.array([6, 1, 3, 4], type=pa.int64()),
                    "s": ["p", "p", "q", "p"],
                }
            ),
        )
        out = c.sql(
            "SELECT g, sum(x) FILTER (WHERE x > 2), min(x) FILTER (WHERE x > 2),"
            " max(s) FILTER (WHERE x > 2), avg(x) FILTER (WHERE x > 2)"
            " FROM t GROUP BY g ORDER BY g"
        ).to_pylist()
        assert [list(r.values()) for r in out] == [
            ["a", 4, 4, "p", 4.0],
            ["c", 9, 3, "q", 4.5],
            ["d", None, None, None, None],
        ]


class TestRound2SurfaceReviewFixes:
    """Fixes from the round-2 self-review of the SQL-surface batches."""

    def _ctx(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE TABLE t AS VALUES ('a', 1), ('a', NULL), ('a', 3), ('b', 2)")
        return c

    def test_similar_to_bracket_expressions(self):
        c = self._ctx()
        run = lambda q: c.sql(q).to_pylist_column(0)[0]
        assert run("SELECT 'ab' SIMILAR TO '[a-c][a-c]'") is True
        assert run("SELECT 'ad' SIMILAR TO '[a-c][a-c]'") is False
        assert run("SELECT 'x' SIMILAR TO '[^y]'") is True
        assert run("SELECT 'y' SIMILAR TO '[^y]'") is False
        assert run("SELECT 'a%' SIMILAR TO 'a[%]'") is True
        assert run("SELECT ']' SIMILAR TO '[]]'") is True
        from sequila_tpu.errors import PlanError
        import pytest as _pytest

        with _pytest.raises(PlanError):
            c.sql("SELECT 'a' SIMILAR TO '[abc'")

    def test_natural_outer_join_no_shared_columns(self):
        c = self._ctx()
        c.sql("CREATE TABLE a2 AS VALUES (1)")
        c.sql("CREATE TABLE b2 (z INTEGER)")
        out = c.sql("SELECT * FROM a2 NATURAL LEFT JOIN b2").to_pylist()
        assert out == [{"column1": 1, "z": None}]  # sqlite/Postgres agree
        assert c.sql("SELECT * FROM a2 NATURAL JOIN b2").num_rows == 0
        assert c.sql("SELECT * FROM a2 NATURAL FULL JOIN b2").num_rows == 1

    def test_agg_order_by_desc_nulls_matches_sortexec(self):
        c = self._ctx()
        top = c.sql(
            "SELECT column2 FROM t WHERE column1 = 'a' ORDER BY column2 DESC"
        ).to_pylist_column(0)
        agg = c.sql(
            "SELECT array_agg(column2 ORDER BY column2 DESC) FROM t"
            " WHERE column1 = 'a'"
        ).to_pylist()[0]
        got = list(agg[next(iter(agg))])
        assert [v if v is None else float(v) for v in top] == [
            v if v is None else float(v) for v in got
        ]  # NULLS FIRST under DESC, same as SortExec

    def test_dangling_agg_order_by_rejected(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError

        c = self._ctx()
        with _pytest.raises(PlanError):
            c.sql("SELECT upper('a' ORDER BY 1)")
        with _pytest.raises(PlanError):
            c.sql(
                "SELECT sum(column2 ORDER BY column2)"
                " OVER (PARTITION BY column1) FROM t"
            )

    def test_execute_arity_checked_without_declared_types(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError

        c = self._ctx()
        c.sql("PREPARE p AS SELECT * FROM t WHERE column2 > $1")
        with _pytest.raises(PlanError):
            c.sql("EXECUTE p(1, 2, 3)")
        with _pytest.raises(PlanError):
            c.sql("EXECUTE p()")
        assert c.sql("EXECUTE p(0)").num_rows == 3

    def test_aliased_order_by_aggregate_single_spec(self):
        c = self._ctx()
        plan = c.sql(
            "EXPLAIN SELECT column1, count(*) AS n FROM t"
            " GROUP BY column1 ORDER BY count(*) DESC"
        ).to_pylist_column(1)
        agg_line = next(p for p in plan if "AggregateExec" in p)
        assert agg_line.count("count(*)") <= 1  # no duplicate twin spec
        out = c.sql(
            "SELECT column1, count(*) AS n FROM t"
            " GROUP BY column1 ORDER BY count(*) DESC"
        ).to_pylist()
        assert [r["n"] for r in out] == [3, 1]
        # HAVING reuses the aliased spec too
        out = c.sql(
            "SELECT column1, sum(column2) AS sv FROM t GROUP BY column1"
            " HAVING sum(column2) > 2 ORDER BY sum(column2) DESC"
        ).to_pylist()
        assert out == [{"column1": "a", "sv": 4}]


class TestRound2PerfPathReviewFixes:
    """Fixes from the second round-2 self-review (fast paths, table
    functions, information_schema)."""

    def test_coalesce_timedelta_falls_back(self):
        import numpy as np
        import pyarrow as pa

        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("d", pa.table({
            "a": pa.array(
                [np.datetime64("2023-01-02", "us"), None],
                type=pa.timestamp("us"),
            ),
            "b": pa.array(
                [np.datetime64("2023-01-01", "us")] * 2,
                type=pa.timestamp("us"),
            ),
        }))
        out = c.sql(
            "SELECT coalesce(a - b, INTERVAL '0 seconds') FROM d"
        ).to_pylist_column(0)
        assert str(out[0]) == "1 day, 0:00:00"
        assert str(out[1]) == "0:00:00"  # NaT coalesces, not -9.2e18

    def test_coalesce_bigint_exact(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE TABLE big AS VALUES (9007199254740993)")
        assert c.sql(
            "SELECT ifnull(column1, 0) FROM big"
        ).to_pylist_column(0) == [9007199254740993]  # not 2^53-rounded

    def test_recursive_view_through_table_function(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE EXTERNAL TABLE reads STORED AS CSV"
              " LOCATION 'testing/data/interval/reads.csv'")
        c.sql("CREATE VIEW va AS SELECT * FROM reads")
        c.sql("CREATE VIEW vb AS SELECT * FROM merge('va')")
        c.sql("CREATE OR REPLACE VIEW va AS SELECT * FROM merge('vb')")
        with _pytest.raises(PlanError, match="recursive"):
            c.sql("SELECT count(*) FROM va")

    def test_trim_control_char_parity(self):
        import pyarrow as pa

        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("w", pa.table({"s": ["\x1cabc\x1f", " x ", None]}))
        fast = c.sql("SELECT trim(s) FROM w").to_pylist_column(0)
        slow = c.sql("SELECT trim(s || '') FROM w").to_pylist_column(0)
        assert fast == slow == ["abc", "x", None]

    def test_information_schema_view_columns(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE TABLE t AS VALUES (1, 'a')")
        c.sql("CREATE VIEW v AS SELECT column1 AS x FROM t")
        cols = c.sql(
            "SELECT column_name FROM information_schema.columns"
            " WHERE table_name = 'v'"
        ).to_pylist_column(0)
        assert cols == ["x"]


class TestRound2AliasReviewFixes:
    """Third self-review round: alias substitution scope, unnest
    robustness, bench/examples platform handling."""

    def test_alias_walk_stops_at_subquery_boundary(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE TABLE t AS VALUES (1),(2),(3)")
        c.sql("CREATE TABLE s2 AS SELECT 100 AS y, 2 AS column1"
              " FROM (SELECT 0) v")
        got = c.sql(
            "SELECT column1 AS y FROM t"
            " ORDER BY abs(y) % (SELECT max(y) FROM s2), column1"
        ).to_pylist_column(0)
        assert got == [1, 2, 3]  # inner y = s2.y (100), not outer alias

    def test_ambiguous_column_not_masked_by_alias(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql("CREATE TABLE a1 AS VALUES (1)")
        c.sql("CREATE TABLE b1 AS VALUES (2)")
        with _pytest.raises(PlanError, match="ambiguous"):
            c.sql(
                "SELECT a1.column1 + 1 AS column1 FROM a1 JOIN b1 ON 1=1"
                " ORDER BY abs(column1)"
            )

    def test_unnest_mixed_types_is_plan_error(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError
        from sequila_tpu.session import SessionContext

        with _pytest.raises(PlanError):
            SessionContext().sql("SELECT * FROM unnest([1,'a'])")
