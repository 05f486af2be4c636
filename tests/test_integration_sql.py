"""SQL integration tests — a mirror of the reference's test-suite
(reference sequila/sequila-core/tests/integration_test.rs): the same
queries, the same fixture data, the same expected outputs, the same
cross-algorithm-equivalence oracle (hash/NLJ baseline = ground truth), and
the same EXPLAIN plan assertions."""

import numpy as np
import pytest

from sequila_tpu import Algorithm, SequilaConfig
from sequila_tpu.session import SessionContext

READS_CSV = """contig,pos_start,pos_end
chr1,150,250
chr1,190,300
chr1,300,501
chr1,500,700
chr1,22000,22300
chr1,15000,15000
chr2,150,250
chr2,190,300
chr2,300,500
chr2,500,700
chr2,22000,22300
chr2,15000,15000
"""

TARGETS_CSV = """contig,pos_start,pos_end
chr1,100,190
chr1,200,290
chr1,400,600
chr1,10000,20000
chr1,22100,22100
chr2,100,190
chr2,200,290
chr2,400,600
chr2,10000,20000
chr2,22100,22100
"""

ALL_ALGORITHMS = [
    None,
    Algorithm.COITREES,
    Algorithm.INTERVAL_TREE,
    Algorithm.ARRAY_INTERVAL_TREE,
    Algorithm.LAPPER,
    Algorithm.SUPER_INTERVALS,
]

# expected_equi fixture (integration_test.rs:40-65)
EXPECTED_EQUI = [
        ("chr1", 150, 250, "chr1", 100, 190),
        ("chr1", 150, 250, "chr1", 200, 290),
        ("chr1", 190, 300, "chr1", 100, 190),
        ("chr1", 190, 300, "chr1", 200, 290),
        ("chr1", 300, 501, "chr1", 400, 600),
        ("chr1", 500, 700, "chr1", 400, 600),
        ("chr1", 15000, 15000, "chr1", 10000, 20000),
        ("chr1", 22000, 22300, "chr1", 22100, 22100),
        ("chr2", 150, 250, "chr2", 100, 190),
        ("chr2", 150, 250, "chr2", 200, 290),
        ("chr2", 190, 300, "chr2", 100, 190),
        ("chr2", 190, 300, "chr2", 200, 290),
        ("chr2", 300, 500, "chr2", 400, 600),
        ("chr2", 500, 700, "chr2", 400, 600),
        ("chr2", 15000, 15000, "chr2", 10000, 20000),
        ("chr2", 22000, 22300, "chr2", 22100, 22100),
]


@pytest.fixture
def ctx(tmp_path):
    reads = tmp_path / "reads.csv"
    targets = tmp_path / "targets.csv"
    reads.write_text(READS_CSV)
    targets.write_text(TARGETS_CSV)
    c = SessionContext(SequilaConfig())
    c.sql(
        f"CREATE EXTERNAL TABLE reads STORED AS CSV LOCATION '{reads}' "
        "OPTIONS ('has_header' 'true')"
    )
    c.sql(
        f"CREATE EXTERNAL TABLE targets STORED AS CSV LOCATION '{targets}' "
        "OPTIONS ('has_header' 'true')"
    )
    return c


def _norm(v):
    if v is None:
        return None
    if isinstance(v, float):
        if v != v:  # NaN <- nulled int column
            return None
        if v == int(v):
            return int(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple((v is None, str(v)) for v in r))


def rows_of(table):
    cols = [table.column_np(i) for i in range(len(table.column_names))]
    return sorted_rows(
        tuple(_norm(v) for v in row)
        for row in zip(*[c.tolist() for c in cols])
    )


def set_algorithm(ctx, algorithm):
    ctx.sql(f"SET sequila.prefer_interval_join = {str(algorithm is not None).lower()}")
    ctx.sql(
        f"SET sequila.interval_join_algorithm = {(algorithm or Algorithm.COITREES).value}"
    )


EQUI_QUERY = """SELECT *
    FROM reads
    JOIN targets
    ON reads.contig = targets.contig
       AND reads.pos_start <= targets.pos_end
       AND reads.pos_end >= targets.pos_start
    ORDER BY reads.contig, reads.pos_start, reads.pos_end,
             targets.contig, targets.pos_start, targets.pos_end"""


@pytest.mark.parametrize("algorithm", ALL_ALGORITHMS, ids=lambda a: str(a))
def test_equi_and_range_condition(ctx, algorithm):
    set_algorithm(ctx, algorithm)

    plan_text = ctx.sql(f"EXPLAIN {EQUI_QUERY}").column_np("plan")[0]
    if algorithm is None:
        assert (
            "HashJoinExec: mode=CollectLeft, join_type=Inner, "
            "on=[(contig@0, contig@0)], "
            "filter=pos_start@0 <= pos_end@3 AND pos_end@1 >= pos_start@2"
            in plan_text
        )
    else:
        assert (
            "IntervalJoinExec: mode=CollectLeft, join_type=Inner, "
            "on=[(contig@0, contig@0)], "
            "filter=pos_start@0 <= pos_end@3 AND pos_end@1 >= pos_start@2, "
            f"alg={algorithm}" in plan_text
        )

    result = ctx.sql(EQUI_QUERY)
    assert rows_of(result) == sorted_rows(EXPECTED_EQUI)


RANGE_QUERY = """SELECT *
    FROM reads
    JOIN targets
    ON reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start
    ORDER BY reads.contig, reads.pos_start, reads.pos_end,
             targets.contig, targets.pos_start, targets.pos_end"""


@pytest.mark.parametrize("algorithm", ALL_ALGORITHMS, ids=lambda a: str(a))
def test_range_condition(ctx, algorithm):
    """No equi-keys: NLJ baseline vs interval join with on=[(1, 1)]
    (integration_test.rs:163-212)."""
    set_algorithm(ctx, algorithm)

    plan_text = ctx.sql(f"EXPLAIN {RANGE_QUERY}").column_np("plan")[0]
    if algorithm is None:
        assert (
            "NestedLoopJoinExec: join_type=Inner, "
            "filter=pos_start@0 <= pos_end@3 AND pos_end@1 >= pos_start@2"
            in plan_text
        )
    else:
        assert (
            "IntervalJoinExec: mode=CollectLeft, join_type=Inner, on=[(1, 1)], "
            "filter=pos_start@0 <= pos_end@3 AND pos_end@1 >= pos_start@2, "
            f"alg={algorithm}" in plan_text
        )

    result = ctx.sql(RANGE_QUERY)
    # cross product over contigs: every reads row x matching targets rows
    # regardless of contig (expected_range, integration_test.rs:120-161)
    expected = []
    for (rc, rs, re_) in [r for r in _parse_csv(READS_CSV)]:
        for (tc, ts, te) in [t for t in _parse_csv(TARGETS_CSV)]:
            if rs <= te and re_ >= ts:
                expected.append((rc, rs, re_, tc, ts, te))
    assert rows_of(result) == sorted_rows(expected)
    assert len(expected) == 32  # the reference expected_range has 32 rows


def _parse_csv(text):
    rows = []
    for line in text.strip().splitlines()[1:]:
        c, s, e = line.split(",")
        rows.append((c, int(s), int(e)))
    return rows


A_TABLE = "CREATE TABLE a (contig TEXT, start INTEGER, end INTEGER) AS VALUES ('a', 5, 10)"
B_TABLE = """CREATE TABLE b (contig TEXT, start INTEGER, end INTEGER) AS VALUES
    ('a', 11, 15), ('a', 10, 15), ('a', 10, 10), ('a', 9, 15),
    ('a', 5, 15), ('a', 4, 15), ('a', 4, 10), ('a', 6, 8),
    ('a', 4, 8), ('a', 4, 5), ('a', 5, 5), ('a', 4, 4)"""

EXPECTED_GTEQ_LTEQ = [
        ("a", 5, 10, "a", 10, 15),
        ("a", 5, 10, "a", 10, 10),
        ("a", 5, 10, "a", 9, 15),
        ("a", 5, 10, "a", 5, 15),
        ("a", 5, 10, "a", 4, 15),
        ("a", 5, 10, "a", 4, 10),
        ("a", 5, 10, "a", 6, 8),
        ("a", 5, 10, "a", 4, 8),
        ("a", 5, 10, "a", 5, 5),
        ("a", 5, 10, "a", 4, 5),
]


def test_all_gteq_lteq_conditions(ctx):
    """Containment/edge matrix, 4 query formulations
    (integration_test.rs:216-291)."""
    ctx.sql(A_TABLE)
    ctx.sql(B_TABLE)
    queries = [
        "SELECT * FROM a JOIN b ON a.contig = b.contig AND a.start <= b.end AND a.end >= b.start",
        "SELECT a.*, b.* FROM b JOIN a ON a.contig = b.contig AND a.start <= b.end AND a.end >= b.start",
        "SELECT a.*, b.* FROM a, b WHERE a.contig = b.contig AND a.start <= b.end AND a.end >= b.start",
        "SELECT a.*, b.* FROM b, a WHERE a.contig = b.contig AND b.start <= a.end AND b.end >= a.start",
    ]
    for q in queries:
        assert rows_of(ctx.sql(q)) == sorted_rows(EXPECTED_GTEQ_LTEQ), q


EXPECTED_GT_LT = [
        ("a", 5, 10, "a", 9, 15),
        ("a", 5, 10, "a", 5, 15),
        ("a", 5, 10, "a", 4, 15),
        ("a", 5, 10, "a", 4, 10),
        ("a", 5, 10, "a", 6, 8),
        ("a", 5, 10, "a", 4, 8),
]


def test_all_gt_lt_conditions(ctx):
    """Strict </> boundary exclusion (integration_test.rs:293-350)."""
    ctx.sql(A_TABLE)
    ctx.sql(B_TABLE)
    queries = [
        "SELECT * FROM a JOIN b ON a.contig = b.contig AND a.start < b.end AND a.end > b.start",
        "SELECT a.*, b.* FROM b JOIN a ON a.contig = b.contig AND a.end > b.start AND a.start < b.end",
    ]
    for q in queries:
        assert rows_of(ctx.sql(q)) == sorted_rows(EXPECTED_GT_LT), q


def test_nearest(ctx):
    """CoitreesNearest semantics (integration_test.rs:352-399)."""
    ctx.sql(
        "CREATE TABLE a (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
        " AS VALUES ('a', 's', 5, 10)"
    )
    ctx.sql(
        "CREATE TABLE b (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
        " AS VALUES ('a', 's', 11, 13), ('a', 's', 20, 21),"
        " ('a', 'x', 0, 1), ('b', 's', 1, 2)"
    )
    ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
    result = ctx.sql(
        "SELECT * FROM a JOIN b ON a.contig = b.contig AND a.strand = b.strand"
        " AND a.start < b.end AND a.end > b.start"
    )
    expected = sorted_rows(
        [
            (None, None, None, None, "a", "x", 0, 1),
            (None, None, None, None, "b", "s", 1, 2),
            ("a", "s", 5, 10, "a", "s", 11, 13),
            ("a", "s", 5, 10, "a", "s", 20, 21),
        ]
    )
    assert rows_of(result) == expected


def test_count_star_fast_path(ctx):
    """count(1) over the interval join goes through IntervalCountExec."""
    set_algorithm(ctx, Algorithm.COITREES)
    q = (
        "SELECT count(1) FROM reads JOIN targets ON reads.contig = targets.contig"
        " AND reads.pos_end >= targets.pos_start AND reads.pos_start <= targets.pos_end"
    )
    plan_text = ctx.sql(f"EXPLAIN {q}").column_np("plan")[0]
    assert "IntervalCountExec" in plan_text
    result = ctx.sql(q)
    assert result.column_np(0)[0] == 16
    # and matches the hash-join baseline
    set_algorithm(ctx, None)
    assert ctx.sql(q).column_np(0)[0] == 16


def test_cast_overflow_errors(ctx):
    """i32 overflow in interval bounds is a hard error
    (interval_join.rs:1927-1968)."""
    from sequila_tpu.errors import CastOverflowError

    ctx.sql(
        "CREATE TABLE big (contig TEXT, start BIGINT, end BIGINT) AS VALUES"
        " ('a', 1, 4294967296)"
    )
    ctx.sql("CREATE TABLE small (contig TEXT, start BIGINT, end BIGINT) AS VALUES ('a', 1, 2)")
    set_algorithm(ctx, Algorithm.COITREES)
    with pytest.raises(CastOverflowError):
        ctx.sql(
            "SELECT * FROM big JOIN small ON big.contig = small.contig"
            " AND big.start <= small.end AND big.end >= small.start"
        )


def test_projection(ctx):
    """Projection over the interval join (interval_join.rs:1814-1843)."""
    set_algorithm(ctx, Algorithm.COITREES)
    result = ctx.sql(
        "SELECT reads.contig, targets.pos_start FROM reads JOIN targets"
        " ON reads.contig = targets.contig"
        " AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start"
    )
    assert result.column_names == ["contig", "pos_start"]
    assert result.num_rows == 16


def test_explain_analyze_has_metrics(ctx):
    set_algorithm(ctx, Algorithm.COITREES)
    out = ctx.sql(f"EXPLAIN ANALYZE {EQUI_QUERY}")
    text = out.column_np("plan")[0]
    assert "metrics=[" in text and "output_rows" in text


def test_low_memory_mode_matches(ctx):
    """Low-memory chunked emission produces identical output
    (SEQUILA_MAX_OUTPUT_BATCH_SIZE analog)."""
    set_algorithm(ctx, Algorithm.COITREES)
    ctx.sql("SET sequila.interval_join_low_memory = true")
    ctx.sql("SET sequila.max_output_batch_size = 300")
    assert rows_of(ctx.sql(EQUI_QUERY)) == sorted_rows(EXPECTED_EQUI)


@pytest.mark.parametrize("threshold", ["0", "65536"])
def test_device_and_host_paths_agree(ctx, monkeypatch, threshold):
    """The same SQL must produce identical results through the device
    (device-kernel) path and the small-query host path."""
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
    set_algorithm(ctx, Algorithm.COITREES)
    assert rows_of(ctx.sql(EQUI_QUERY)) == sorted_rows(EXPECTED_EQUI)
    q = (
        "SELECT count(1) FROM reads JOIN targets ON reads.contig = targets.contig"
        " AND reads.pos_end >= targets.pos_start AND reads.pos_start <= targets.pos_end"
    )
    assert ctx.sql(q).column_np(0)[0] == 16


@pytest.mark.parametrize("threshold", ["0", "65536"])
def test_nearest_paths_agree(ctx, monkeypatch, threshold):
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
    ctx.sql(
        "CREATE TABLE an (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
        " AS VALUES ('a', 's', 5, 10)"
    )
    ctx.sql(
        "CREATE TABLE bn (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
        " AS VALUES ('a', 's', 11, 13), ('a', 's', 20, 21),"
        " ('a', 'x', 0, 1), ('b', 's', 1, 2)"
    )
    ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
    result = ctx.sql(
        "SELECT * FROM an JOIN bn ON an.contig = bn.contig AND an.strand = bn.strand"
        " AND an.start < bn.end AND an.end > bn.start"
    )
    assert result.num_rows == 4
    # two NULL-left rows for absent keys
    assert sum(1 for v in result.column_np(0).tolist() if v is None) == 2


JOIN_TYPE_QUERIES = {
    "left": "SELECT * FROM reads LEFT JOIN targets ON reads.contig = targets.contig AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start",
    "right": "SELECT * FROM reads RIGHT JOIN targets ON reads.contig = targets.contig AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start",
    "full": "SELECT * FROM reads FULL JOIN targets ON reads.contig = targets.contig AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start",
}


@pytest.mark.parametrize("jt", ["left", "right", "full"])
@pytest.mark.parametrize("use_interval", [True, False], ids=["interval", "hash"])
def test_outer_join_types(ctx, monkeypatch, jt, use_interval):
    """Outer joins: interval path must equal the hash-join baseline; both
    must contain the 16 inner rows + the correct NULL-padded extras."""
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0" if use_interval else "65536")
    set_algorithm(ctx, Algorithm.COITREES if use_interval else None)
    got = rows_of(ctx.sql(JOIN_TYPE_QUERIES[jt]))
    # oracle: build from inner matches
    reads = _parse_csv(READS_CSV)
    targets = _parse_csv(TARGETS_CSV)
    inner = [
        (rc, rs, re_, tc, ts, te)
        for (rc, rs, re_) in reads
        for (tc, ts, te) in targets
        if rc == tc and rs <= te and re_ >= ts
    ]
    matched_l = {(rc, rs, re_) for (rc, rs, re_, *_r) in inner}
    matched_r = {tuple(r[3:]) for r in inner}
    expected = list(inner)
    if jt in ("left", "full"):
        expected += [
            (rc, rs, re_, None, None, None)
            for (rc, rs, re_) in reads
            if (rc, rs, re_) not in matched_l
        ]
    if jt in ("right", "full"):
        expected += [
            (None, None, None, tc, ts, te)
            for (tc, ts, te) in targets
            if (tc, ts, te) not in matched_r
        ]
    assert got == sorted_rows(expected), jt


@pytest.mark.parametrize("use_fast", [True, False], ids=["fastpath", "baseline"])
def test_group_by_contig_count(ctx, use_fast):
    """count(*) GROUP BY contig over the interval join — grouped fast path
    must match the hash-join aggregate baseline."""
    set_algorithm(ctx, Algorithm.COITREES if use_fast else None)
    q = (
        "SELECT reads.contig, count(1) AS n FROM reads JOIN targets"
        " ON reads.contig = targets.contig"
        " AND reads.pos_end >= targets.pos_start AND reads.pos_start <= targets.pos_end"
        " GROUP BY reads.contig ORDER BY reads.contig"
    )
    if use_fast:
        plan = ctx.sql(f"EXPLAIN {q}").column_np("plan")[0]
        assert "GroupedIntervalCountExec" in plan, plan
    out = ctx.sql(q)
    assert rows_of(out) == [("chr1", 8), ("chr2", 8)]


def test_copy_to(ctx, tmp_path):
    set_algorithm(ctx, Algorithm.COITREES)
    out_pq = tmp_path / "out.parquet"
    out_csv = tmp_path / "out.csv"
    q = (
        "COPY (SELECT * FROM reads JOIN targets ON reads.contig = targets.contig"
        " AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start)"
        f" TO '{out_pq}'"
    )
    res = ctx.sql(q)
    assert res.column_np("count")[0] == 16
    ctx.sql(f"COPY reads TO '{out_csv}'")
    import pyarrow.parquet as pq

    assert pq.read_table(out_pq).num_rows == 16
    assert out_csv.read_text().startswith('"contig"') or out_csv.read_text().startswith("contig")


def test_memory_limit_enforced(ctx, monkeypatch):
    """SEQUILA_MEMORY_LIMIT analog of the reference's memory-pool
    try_grow: a build too big for the pool fails with a clear error."""
    from sequila_tpu.errors import ExecutionError

    monkeypatch.setenv("SEQUILA_MEMORY_LIMIT", "100")
    set_algorithm(ctx, Algorithm.COITREES)
    with pytest.raises(ExecutionError, match="Resources exhausted"):
        ctx.sql(EQUI_QUERY)
    monkeypatch.setenv("SEQUILA_MEMORY_LIMIT", "0")
    assert rows_of(ctx.sql(EQUI_QUERY)) == sorted_rows(EXPECTED_EQUI)


def test_build_mem_metric_reported(ctx):
    set_algorithm(ctx, Algorithm.COITREES)
    out = ctx.sql(f"EXPLAIN ANALYZE {EQUI_QUERY}")
    assert "build_mem_used" in out.column_np("plan")[0]


def test_projection_pushdown_into_join(ctx):
    """Pure-column projections fold into IntervalJoinExec (the reference
    operator's `projection` member) and gather only those columns."""
    set_algorithm(ctx, Algorithm.COITREES)
    q = (
        "SELECT reads.pos_start, targets.pos_end FROM reads JOIN targets"
        " ON reads.contig = targets.contig"
        " AND reads.pos_start <= targets.pos_end AND reads.pos_end >= targets.pos_start"
    )
    plan = ctx.sql(f"EXPLAIN {q}").column_np("plan")[0]
    assert "projection=[1, 5]" in plan, plan
    assert "ProjectionExec" not in plan
    out = ctx.sql(q)
    assert out.column_names == ["pos_start", "pos_end"]
    assert out.num_rows == 16
    # results equal the unfused projection over the hash baseline
    set_algorithm(ctx, None)
    assert rows_of(ctx.sql(q)) == rows_of(ctx.sql(q))
    base = ctx.sql(q)
    set_algorithm(ctx, Algorithm.COITREES)
    assert rows_of(ctx.sql(q)) == rows_of(base)


def test_low_memory_dense_output_cap(ctx, monkeypatch):
    """A dense region emitting >>100 rows per probe must still respect
    the low-memory emit cap via probe-chunk halving."""
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")  # device path
    n = 500  # 500 matches/probe row: 5-row chunks estimate 2500 > 4*500,
    # so the halving branch (chunk 5 -> 2) actually executes
    ctx.sql(
        "CREATE TABLE dl (contig TEXT, s INTEGER, e INTEGER) AS VALUES "
        + ", ".join(f"('c', {i}, {i + 100000})" for i in range(n))
    )
    ctx.sql(
        "CREATE TABLE dr (contig TEXT, s INTEGER, e INTEGER) AS VALUES "
        + ", ".join(f"('c', {i}, {i + 100000})" for i in range(n))
    )
    set_algorithm(ctx, Algorithm.COITREES)
    ctx.sql("SET sequila.interval_join_low_memory = true")
    ctx.sql("SET sequila.max_output_batch_size = 500")
    q = ("SELECT count(1) FROM dl JOIN dr ON dl.contig = dr.contig"
         " AND dl.s <= dr.e AND dl.e >= dr.s")
    dense_count = int(ctx.sql(q).column_np(0)[0])
    out = ctx.sql(
        "SELECT * FROM dl JOIN dr ON dl.contig = dr.contig"
        " AND dl.s <= dr.e AND dl.e >= dr.s"
    )
    assert out.num_rows == dense_count
    assert dense_count == n * n  # all pairs overlap
    # lapper in low-memory routes through level emission (bounded buffer)
    set_algorithm(ctx, Algorithm.LAPPER)
    assert ctx.sql(q).column_np(0)[0] == dense_count


def test_null_interval_bounds_error(ctx):
    from sequila_tpu.errors import ExecutionError

    ctx.sql("CREATE TABLE nb1 (k TEXT, s INTEGER, e INTEGER) AS VALUES ('a', 1, NULL)")
    ctx.sql("CREATE TABLE nb2 (k TEXT, s INTEGER, e INTEGER) AS VALUES ('a', 1, 5)")
    set_algorithm(ctx, Algorithm.COITREES)
    with pytest.raises(ExecutionError, match="NULL"):
        ctx.sql(
            "SELECT * FROM nb1 JOIN nb2 ON nb1.k = nb2.k"
            " AND nb1.s <= nb2.e AND nb1.e >= nb2.s"
        )


def test_between_point_in_interval_join(ctx):
    """ON a.pos BETWEEN b.s AND b.e desugars to the 2-conjunct range and
    the interval-join rewrite fires (point intervals: start = end)."""
    import pyarrow as pa

    ctx.register_table("snp", pa.table({"contig": ["c1", "c1", "c2"], "pos": [100, 400, 5]}))
    ctx.register_table("genes", pa.table({"contig": ["c1", "c2"], "s": [50, 1], "e": [150, 10]}))
    q = ("SELECT count(*) FROM snp a JOIN genes b ON a.contig = b.contig "
         "AND a.pos BETWEEN b.s AND b.e")
    assert ctx.sql(q).column_np(0)[0] == 2
    plan = ctx.sql("EXPLAIN " + q).column_np("plan")[0]
    assert "IntervalJoinExec" in plan


class TestGenomicTableFunctions:
    """The dataframe verb layer reachable from SQL: FROM merge('t'),
    count_overlaps('a','b'), ... — engine extension (the reference's
    closest/complement operators were empty placeholders)."""

    def _ctx(self):
        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.sql(
            "CREATE EXTERNAL TABLE reads STORED AS CSV"
            " LOCATION 'testing/data/interval/reads.csv'"
        )
        c.sql(
            "CREATE EXTERNAL TABLE targets STORED AS CSV"
            " LOCATION 'testing/data/interval/targets.csv'"
        )
        return c

    def test_pairwise_functions(self):
        c = self._ctx()
        assert c.sql(
            "SELECT count(*) FROM overlap('reads', 'targets')"
        ).to_pylist_column(0) == [16]
        counted = c.sql(
            "SELECT sum(count) FROM count_overlaps('reads', 'targets')"
        ).to_pylist_column(0)
        assert counted == [16]
        jac = c.sql("SELECT * FROM jaccard('reads', 'targets')").to_pylist()[0]
        assert set(jac) == {"intersection", "union", "jaccard", "n_intersections"}
        assert c.sql(
            "SELECT count(*) FROM window('reads', 'targets', 100000)"
        ).to_pylist_column(0)[0] >= 16
        assert c.sql(
            "SELECT count(*) FROM nearest('reads', 'targets')"
        ).to_pylist_column(0)[0] == 12  # one row per reads row

    def test_single_table_functions(self):
        c = self._ctx()
        m = c.sql("SELECT * FROM merge('reads')")
        assert m.column_names == ["contig", "pos_start", "pos_end"]
        assert 0 < m.num_rows <= 12
        d = c.sql("SELECT max(depth) FROM depth('reads')").to_pylist_column(0)
        assert d[0] >= 1
        cl = c.sql("SELECT * FROM cluster('reads', 1000000)")
        assert "cluster" in cl.column_names

    def test_composes_with_engine(self):
        c = self._ctx()
        out = c.sql(
            "SELECT m.contig, count(*) AS n FROM merge('reads') m"
            " JOIN targets b ON m.contig = b.contig"
            " AND m.pos_end >= b.pos_start AND m.pos_start <= b.pos_end"
            " GROUP BY m.contig ORDER BY m.contig"
        ).to_pylist()
        assert [r["contig"] for r in out] == ["chr1", "chr2"]
        # table functions see views too
        c.sql("CREATE VIEW chr1_reads AS SELECT * FROM reads WHERE contig = 'chr1'")
        assert c.sql(
            "SELECT count(*) FROM merge('chr1_reads')"
        ).to_pylist_column(0)[0] >= 1

    def test_errors(self):
        import pytest as _pytest

        from sequila_tpu.errors import PlanError

        c = self._ctx()
        with _pytest.raises(PlanError):
            c.sql("SELECT * FROM merge('nope')")
        with _pytest.raises(PlanError):
            c.sql("SELECT * FROM closest('reads')")
        with _pytest.raises(PlanError):
            c.sql("SELECT * FROM window('reads', 'targets')")


class TestGenomicTableFunctionStrand:
    def test_strand_argument(self):
        import pyarrow as pa

        from sequila_tpu.session import SessionContext

        c = SessionContext()
        c.register_table("sa", pa.table({
            "contig": ["chr1", "chr1"], "pos_start": [100, 200],
            "pos_end": [150, 250], "strand": ["+", "-"],
        }))
        c.register_table("sb", pa.table({
            "contig": ["chr1", "chr1"], "pos_start": [120, 210],
            "pos_end": [220, 260], "strand": ["+", "-"],
        }))
        run = lambda q: c.sql(q).to_pylist_column(0)
        assert run("SELECT sum(count) FROM count_overlaps('sa','sb')") == [3]
        assert run(
            "SELECT sum(count) FROM count_overlaps('sa','sb','same')"
        ) == [2]
        assert run(
            "SELECT sum(count) FROM count_overlaps('sa','sb','opposite')"
        ) == [1]
        assert run("SELECT count(*) FROM overlap('sa','sb','same')") == [2]
        assert run(
            "SELECT count(*) FROM window('sa','sb', 1000, 'same')"
        ) == [2]
        assert run(
            "SELECT count(*) FROM closest('sa','sb', 1, 'same')"
        ) == [2]
