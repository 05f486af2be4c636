"""Native C++ host index: build + parity vs NumPy host path and oracles."""

import numpy as np
import pytest

from sequila_tpu.ops.host_join import HostIntervalIndex
from sequila_tpu.ops.oracle import oracle_counts, oracle_pairs

native = pytest.importorskip("sequila_tpu.native.loader")


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def _tables(rng, n, m):
    bk = rng.integers(0, 5, n).astype(np.int32)
    bs = rng.integers(0, 5000, n).astype(np.int32)
    be = bs + rng.integers(0, 400, n).astype(np.int32)
    qk = rng.integers(0, 6, m).astype(np.int32)
    qs = rng.integers(0, 5000, m).astype(np.int32)
    qe = qs + rng.integers(0, 400, m).astype(np.int32)
    return bk, bs, be, qk, qs, qe


def test_native_counts_match_oracle(lib_available, rng):
    bk, bs, be, qk, qs, qe = _tables(rng, 500, 300)
    idx = native.NativeIntervalIndex(bk, bs, be)
    np.testing.assert_array_equal(
        idx.counts(qk, qs, qe), oracle_counts(bk, bs, be, qk, qs, qe)
    )


def test_native_degenerate_stabbing(lib_available):
    idx = native.NativeIntervalIndex(
        np.array([0], np.int32), np.array([0], np.int32), np.array([100], np.int32)
    )
    got = idx.counts(
        np.array([0], np.int32), np.array([50], np.int32), np.array([10], np.int32)
    )
    assert got[0] == 1  # [0,100] stabs the inverted query


def test_native_pairs_match_numpy(lib_available, rng):
    bk, bs, be, qk, qs, qe = _tables(rng, 400, 250)
    nat = native.NativeIntervalIndex(bk, bs, be)
    ref = HostIntervalIndex(bk, bs, be)
    nb, npr = nat.pairs(qk, qs, qe)
    rb, rp = ref.pairs(qk, qs, qe)
    assert sorted(zip(npr.tolist(), nb.tolist())) == sorted(
        zip(rp.tolist(), rb.tolist())
    )
    ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
    assert sorted(zip(npr.tolist(), nb.tolist())) == sorted(
        zip(op.tolist(), ob.tolist())
    )


def test_native_nearest_matches_numpy(lib_available, rng):
    bk, bs, be, qk, qs, qe = _tables(rng, 300, 200)
    nat = native.NativeIntervalIndex(bk, bs, be)
    ref = HostIntervalIndex(bk, bs, be)
    got = nat.nearest(qk, qs, qe)
    want = ref.nearest(qk, qs, qe)
    for i in range(len(qk)):
        if want[i] == -1 or got[i] == -1:
            assert want[i] == got[i], i
            continue
        # equal distance / overlap class (identity may differ on ties)
        def d(j):
            if be[j] < qs[i]:
                return qs[i] - be[j]
            if bs[j] > qe[i]:
                return bs[j] - qe[i]
            return 0
        assert d(got[i]) == d(want[i]), i


def test_native_coverage(lib_available, rng):
    bk, bs, be, qk, qs, qe = _tables(rng, 300, 150)
    nat = native.NativeIntervalIndex(bk, bs, be)
    c, b = nat.coverage(qk, qs, qe)
    for i in range(len(qk)):
        mask = (bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i])
        assert c[i] == mask.sum()
        want = np.sum(
            np.minimum(be[mask], qe[i]).astype(np.int64)
            - np.maximum(bs[mask], qs[i])
        )
        assert b[i] == want


def test_native_pairs_inverted_build(lib_available, rng):
    """Inverted build intervals (end < start) disable BITS counting; the
    count/emit pair must stay consistent (emit is offset-driven)."""
    bk = np.zeros(6, np.int32)
    bs = np.array([0, 100, 50, 10, 70, 30], np.int32)
    be = np.array([90, 20, 60, 5, 200, 30], np.int32)  # two inverted rows
    qk = np.zeros(4, np.int32)
    qs = np.array([0, 55, 150, 300], np.int32)
    qe = np.array([200, 65, 180, 400], np.int32)
    nat = native.NativeIntervalIndex(bk, bs, be)
    nb, npr = nat.pairs(qk, qs, qe)
    ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
    assert sorted(zip(npr.tolist(), nb.tolist())) == sorted(
        zip(op.tolist(), ob.tolist())
    )
    np.testing.assert_array_equal(
        nat.counts(qk, qs, qe), oracle_counts(bk, bs, be, qk, qs, qe)
    )


def test_native_table_take_matches_arrow(lib_available, rng):
    """The native gather kernels (si_gather32/64, si_take_str_*) must be
    bit-identical to arrow compute take across types, including strings
    of mixed lengths (short-string fast path + long rows) and null masks."""
    import pyarrow as pa

    from sequila_tpu.models.table import _TAKE_NATIVE_MIN, Table

    n_src = 1000
    words = np.array(
        ["", "a", "chr1", "x" * 15, "y" * 16, "z" * 40, "contig_%d"]
    )
    t = pa.table({
        "s": pa.array([str(words[i % len(words)]) % i if "%" in str(words[i % len(words)]) else str(words[i % len(words)]) for i in range(n_src)]),
        "i64": pa.array(rng.integers(-(2**40), 2**40, n_src)),
        "i32": pa.array(rng.integers(-(2**30), 2**30, n_src).astype(np.int32)),
        "f64": pa.array(rng.random(n_src)),
        "b": pa.array(rng.random(n_src) < 0.5),  # bool -> arrow fallback
    })
    idx = rng.integers(0, n_src, _TAKE_NATIVE_MIN + 123).astype(np.int64)
    T = Table(t)

    def decoded(tab):
        # low-cardinality string columns gather as dictionary codes
        # (Table._take_source) — compare VALUES against plain arrow take
        cols = [
            c.cast(c.type.value_type) if pa.types.is_dictionary(c.type) else c
            for c in tab.columns
        ]
        return pa.Table.from_arrays(cols, names=tab.column_names)

    got = T.take(idx)
    assert pa.types.is_dictionary(got.arrow.schema.types[0])
    want = t.take(pa.array(idx))
    assert decoded(got.arrow).equals(want)
    # with a null mask (nearest-style NULL-padded side)
    mask = rng.random(len(idx)) < 0.1
    got = T.take(idx, null_mask=mask)
    want = t.take(pa.array(np.where(mask, 0, idx), mask=mask))
    assert decoded(got.arrow).equals(want)
    # column_np must decode dictionary NULLs to None, not dictionary[0]
    s_np = got.column_np("s")
    assert all(v is None for v in s_np[mask])


def test_dict_take_disabled_env(lib_available, rng, monkeypatch):
    """SEQUILA_DICT_TAKE=0 keeps string outputs plain (escape hatch)."""
    import pyarrow as pa

    from sequila_tpu.models.table import _TAKE_NATIVE_MIN, Table

    monkeypatch.setenv("SEQUILA_DICT_TAKE", "0")
    t = pa.table({"s": pa.array(["a", "b"] * 500)})
    idx = rng.integers(0, 1000, _TAKE_NATIVE_MIN + 5).astype(np.int64)
    got = Table(t).take(idx)
    assert got.arrow.schema.types[0] == pa.string()
    assert got.arrow.equals(t.take(pa.array(idx)))


def test_materialize_route_cost_model(monkeypatch):
    """Routing: small inputs -> host; threshold 0 -> device; large inputs
    use the link-vs-host-compute cost model (the measured PCIe profile
    sends them to the device, a slow link keeps them on the host)."""
    from types import SimpleNamespace

    from sequila_tpu.exec.joins.interval_join import IntervalJoinExec

    ij = IntervalJoinExec.__new__(IntervalJoinExec)

    def tbl(n):
        return SimpleNamespace(num_rows=n)  # the router only reads num_rows

    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "65536")
    assert ij._route_materialize_host(tbl(100), tbl(100)) is True
    # 20k x 300k on the default (measured PCIe) profile: the transfer is
    # cheaper than the host compute
    assert ij._route_materialize_host(tbl(20_000), tbl(300_000)) is False
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    assert ij._route_materialize_host(tbl(100), tbl(100)) is False
    # a slow link (30 ms round trip, 38 MB/s) keeps the same shape on the host
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "65536")
    monkeypatch.setenv("SEQUILA_LINK_BW", "38e6")
    monkeypatch.setenv("SEQUILA_LINK_RTT", "0.030")
    assert ij._route_materialize_host(tbl(20_000), tbl(300_000)) is True
    # a fast link sends large probes to the device
    monkeypatch.setenv("SEQUILA_LINK_BW", "1e12")
    monkeypatch.setenv("SEQUILA_LINK_RTT", "0.0")
    assert ij._route_materialize_host(tbl(20_000_000), tbl(30_000_000)) is False


def test_numpy_host_path_parity_with_oracle(rng):
    """The pure-NumPy fallback is exact too (SEQUILA_NATIVE=0 path)."""
    bk, bs, be, qk, qs, qe = _tables(rng, 350, 220)
    ref = HostIntervalIndex(bk, bs, be)
    np.testing.assert_array_equal(
        ref.counts(qk, qs, qe), oracle_counts(bk, bs, be, qk, qs, qe)
    )


def test_choose_distribution_matrix():
    """Unit matrix for the Partitioned-mode distribution chooser."""
    from types import SimpleNamespace

    from sequila_tpu.exec.joins.interval_join import IntervalJoinExec

    mesh = SimpleNamespace(shape={"part": 4, "probe": 2})

    def mk(dist="auto"):
        ij = IntervalJoinExec.__new__(IntervalJoinExec)
        ij.distribution = dist
        return ij

    def args(skewed=False, degenerate=False, inverted=False, nulls=False):
        n, m = 64, 128
        rng = np.random.default_rng(0)
        lk = (np.zeros(n) if skewed else rng.integers(0, 16, n)).astype(np.int32)
        rk = (np.zeros(m) if skewed else rng.integers(0, 16, m)).astype(np.int32)
        if nulls:
            lk[0] = -1
        ls = rng.integers(0, 1000, n).astype(np.int32)
        le = ls + 10
        rs = rng.integers(0, 1000, m).astype(np.int32)
        re_ = rs + 10
        if degenerate:
            re_[0] = rs[0] - 5
        if inverted:
            le[0] = ls[0] - 5
        return lk, ls, le.astype(np.int32), rk, rs, re_.astype(np.int32)

    # auto: flat keys -> shuffle; dominant key -> skew
    assert mk()._choose_distribution(mesh, *args(), "count") == "shuffle"
    assert mk()._choose_distribution(mesh, *args(skewed=True), "count") == "skew"
    # degenerate probes: BITS-based shuffle count and skew are unsafe ->
    # hash for counts; shuffle pairs (window emission) stays exact
    assert mk()._choose_distribution(mesh, *args(degenerate=True), "count") == "hash"
    assert (
        mk()._choose_distribution(mesh, *args(degenerate=True), "pairs")
        == "shuffle"
    )
    assert mk()._choose_distribution(mesh, *args(inverted=True), "count") == "hash"
    # NULL-key sentinels: no bincount -> never skew; shuffle still fine
    assert mk()._choose_distribution(mesh, *args(nulls=True), "count") == "shuffle"
    # forced strategies fall back to hash only when unsafe
    assert mk("skew")._choose_distribution(mesh, *args(), "count") == "skew"
    assert (
        mk("skew")._choose_distribution(mesh, *args(degenerate=True), "count")
        == "hash"
    )
    assert mk("hash")._choose_distribution(mesh, *args(skewed=True), "count") == "hash"
    assert (
        mk("shuffle")._choose_distribution(mesh, *args(degenerate=True), "pairs")
        == "shuffle"
    )


class TestNativeClosestK:
    """si_closest_k: threaded 3-ring merge vs the exact per-row scan.

    Contract (ops/genomic.py closest_k): the top-k distance multiset is
    exact; row ids must be valid same-key rows whose true distance equals
    the claimed one (overlap-tie subsets are deterministic but not
    contractual)."""

    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_matches_scan_distances(self, rng, k):
        from sequila_tpu.native.loader import NativeIntervalIndex, available
        from sequila_tpu.ops.genomic import _closest_k_scan
        from sequila_tpu.ops.interval_index import build_interval_index

        if not available():
            pytest.skip("native library unavailable")
        for _ in range(8):
            n = int(rng.integers(1, 250))
            m = int(rng.integers(1, 200))
            bk = rng.integers(0, 4, n).astype(np.int32)
            bs = rng.integers(0, 30_000, n).astype(np.int32)
            be = bs + rng.integers(0, 400, n).astype(np.int32)
            qk = rng.integers(0, 5, m).astype(np.int32)
            qs = rng.integers(0, 30_000, m).astype(np.int32)
            qe = qs + rng.integers(0, 400, m).astype(np.int32)
            idx = build_interval_index(bk, bs, be, to_device=np.asarray)
            srows, sdists = _closest_k_scan(idx, qk, qs, qe, k)
            nrows, ndists = NativeIntervalIndex(bk, bs, be).closest_k(
                qk, qs, qe, k
            )
            np.testing.assert_array_equal(ndists, sdists)
            for i in range(m):
                for j in range(k):
                    r = int(nrows[i, j])
                    if r < 0:
                        assert srows[i, j] < 0
                        continue
                    assert bk[r] == qk[i]
                    d = (
                        qs[i] - be[r]
                        if be[r] < qs[i]
                        else (bs[r] - qe[i] if bs[r] > qe[i] else 0)
                    )
                    assert d == ndists[i, j]

    def test_dataframe_closest_k_routes_native(self, rng):
        """gdf.closest(k>1) on clean inputs gives the same distance table
        whether native routes or the numpy vectorized path runs."""
        import pyarrow as pa

        import sequila_tpu.dataframe as gdf
        from sequila_tpu.models.table import Table
        from sequila_tpu.native.loader import available

        if not available():
            pytest.skip("native library unavailable")
        n = 400
        t = {}
        for side, seed in (("a", 1), ("b", 2)):
            r = np.random.default_rng(seed)
            s = r.integers(0, 20_000, n).astype(np.int64)
            t[side] = Table(
                pa.table(
                    {
                        "contig": np.repeat(["chr1", "chr2"], n // 2),
                        "pos_start": s,
                        "pos_end": s + r.integers(0, 200, n),
                    }
                )
            )
        out = gdf.closest(t["a"], t["b"], k=3)
        # numpy reference path: force-disable native routing by patching
        # availability (env alone can't unload the cached lib)
        import sequila_tpu.native.loader as nl

        orig = nl.available
        nl.available = lambda: False
        try:
            ref = gdf.closest(t["a"], t["b"], k=3)
        finally:
            nl.available = orig
        assert out.num_rows == ref.num_rows
        np.testing.assert_array_equal(
            np.sort(out.column_np("distance")),
            np.sort(ref.column_np("distance")),
        )


class TestNativeVectorOps:
    """si_argsort64 (parallel stable LSD radix) and si_searchsorted64
    (threaded binary search) vs numpy on random int64 data."""

    def test_argsort64_matches_stable(self, rng):
        from sequila_tpu.native.loader import argsort64, available

        if not available():
            pytest.skip("native library unavailable")
        for n in (0, 1, 2, 7, 1000, 123_457):
            v = rng.integers(-(2**62), 2**62, max(n, 1))[:n].astype(np.int64)
            np.testing.assert_array_equal(
                argsort64(v).astype(np.int64), np.argsort(v, kind="stable")
            )
        dup = rng.integers(0, 5, 50_000).astype(np.int64)  # stability
        np.testing.assert_array_equal(
            argsort64(dup).astype(np.int64), np.argsort(dup, kind="stable")
        )

    def test_searchsorted64_matches(self, rng):
        from sequila_tpu.native.loader import available, searchsorted64

        if not available():
            pytest.skip("native library unavailable")
        s = np.sort(rng.integers(-(2**40), 2**40, 100_000)).astype(np.int64)
        q = rng.integers(-(2**40), 2**40, 60_000).astype(np.int64)
        q[:100] = s[:100]  # exact hits exercise the side semantics
        for side in ("left", "right"):
            np.testing.assert_array_equal(
                searchsorted64(s, q, side), np.searchsorted(s, q, side=side)
            )


def test_fast_lexsort_uint64_ordering():
    """uint64 keys above 2^63 must not wrap through the int64 radix."""
    from sequila_tpu.exec.plan import _fast_lexsort, _stable_argsort_int

    v = np.array(
        [2**63 + 5, 3, 2**64 - 1, 0, 2**63], dtype=np.uint64
    ).repeat(20_000)
    np.testing.assert_array_equal(
        _stable_argsort_int(v), np.argsort(v, kind="stable")
    )
    np.testing.assert_array_equal(_fast_lexsort([v]), np.lexsort((v,)))
    from sequila_tpu.exec.plan import _row_group_codes

    codes, _ = _row_group_codes([v])
    np.testing.assert_array_equal(codes, np.unique(v, return_inverse=True)[1])


def test_native_extreme_coordinate_emission(lib_available, rng):
    """int32-extreme coordinates exercise the level hint grids' widest
    span (2^32-1) and the searchsorted hint path's clamping; counts and
    pairs must match the oracle exactly."""
    n, m = 600, 400
    lo, hi = -(2**31), 2**31 - 1
    bs = rng.integers(lo, hi - 1000, n).astype(np.int64)
    bk = rng.integers(0, 3, n).astype(np.int32)
    be = (bs + rng.integers(0, 2**31, n)).clip(lo, hi - 1).astype(np.int32)
    bs = bs.astype(np.int32)
    qs = rng.integers(lo, hi - 1000, m).astype(np.int64)
    qk = rng.integers(0, 4, m).astype(np.int32)
    qe = (qs + rng.integers(0, 2**31, m)).clip(lo, hi - 1).astype(np.int32)
    qs = qs.astype(np.int32)
    # a few exact-extreme rows
    bs[:3] = [lo, lo, hi - 1]
    be[:3] = [lo, hi - 1, hi - 1]
    qs[:3] = [lo, hi - 1, lo]
    qe[:3] = [hi - 1, hi - 1, lo]
    idx = native.NativeIntervalIndex(bk, bs, be)
    got = idx.counts(qk, qs, qe)
    want = oracle_counts(bk, bs, be, qk, qs, qe)
    np.testing.assert_array_equal(got, want)
    nb, npr = idx.pairs(qk, qs, qe)
    ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
    assert sorted(zip(npr.tolist(), nb.tolist())) == sorted(
        zip(op.tolist(), ob.tolist())
    )


def test_sorted_walk_emission_parity(lib_available, rng, monkeypatch):
    """SEQUILA_EMIT_SORTED_WALK forces the beyond-cache emission branch
    (radix query order + per-level monotone gallop cursors) at test
    sizes; its output must be identical to the plain walk, including
    inverted builds and degenerate stabbing probes."""
    bk, bs, be, qk, qs, qe = _tables(rng, 800, 600)
    be = np.where(rng.random(800) < 0.1, bs - 50, be)  # inverted rows
    qe = np.where(rng.random(600) < 0.1, qs - 30, qe)  # stabbing probes
    idx = native.NativeIntervalIndex(bk, bs, be)
    monkeypatch.setenv("SEQUILA_EMIT_SORTED_WALK", "0")
    pb, pp = idx.pairs(qk, qs, qe)
    monkeypatch.setenv("SEQUILA_EMIT_SORTED_WALK", "1")
    sb, sp = idx.pairs(qk, qs, qe)
    np.testing.assert_array_equal(pb, sb)
    np.testing.assert_array_equal(pp, sp)
    ob, op = oracle_pairs(bk, bs, be, qk, qs, qe)
    assert sorted(zip(sp.tolist(), sb.tolist())) == sorted(
        zip(op.tolist(), ob.tolist())
    )


def test_native_subtract_runs_parity(lib_available, rng, monkeypatch):
    """si_subtract_count/emit must be bit-identical — values AND order —
    to the NumPy pair-expansion path in ops/genomic.subtract_intervals,
    across degenerate a-rows, multi-key data, negative coordinates and
    int32-extreme spans."""
    from sequila_tpu.native import loader
    from sequila_tpu.ops import genomic

    def numpy_path(ak, as_, ae, bk, bs, be):
        monkeypatch.setattr(loader, "subtract_runs", lambda *a, **k: None)
        try:
            return genomic.subtract_intervals(ak, as_, ae, bk, bs, be)
        finally:
            monkeypatch.undo()

    for trial in range(12):
        n = int(rng.integers(0, 1500))
        m = int(rng.integers(0, 1500))
        span = int(rng.integers(10, 100_000))
        ak = rng.integers(0, 5, m).astype(np.int32)
        as_ = rng.integers(-span // 2, span, m).astype(np.int32)
        # includes degenerate (start > end) a-rows on purpose
        ae = (as_ + rng.integers(-5, span // 3, m)).astype(np.int32)
        bk = rng.integers(0, 5, n).astype(np.int32)
        bs = rng.integers(-span // 2, span, n).astype(np.int32)
        be = (bs + rng.integers(0, span // 3, n)).astype(np.int32)
        got = genomic.subtract_intervals(ak, as_, ae, bk, bs, be)
        exp = numpy_path(ak, as_, ae, bk, bs, be)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e, err_msg=f"trial {trial}")

    # int32 extremes: spans touching both ends of the coordinate range
    ak = np.array([0, 0, 1], np.int32)
    as_ = np.array([-(2**31), 2**31 - 10, 0], np.int32)
    ae = np.array([-(2**31) + 100, 2**31 - 1, 2**31 - 1], np.int32)
    bk = np.array([0, 0, 1], np.int32)
    bs = np.array([-(2**31) + 5, 2**31 - 8, 100], np.int32)
    be = np.array([-(2**31) + 50, 2**31 - 2, 2**31 - 5], np.int32)
    got = genomic.subtract_intervals(ak, as_, ae, bk, bs, be)
    exp = numpy_path(ak, as_, ae, bk, bs, be)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


def test_native_coverage_rank_decomposition(lib_available, rng):
    """si_coverage's 4-rank fast path (prefix sums over the two sorted
    views) must equal the brute-force predicate start<=qe AND end>=qs —
    including degenerate probes (qs > qe, per-probe scan fallback) and
    inverted-build indexes (whole-call scan fallback)."""
    for trial in range(8):
        n = int(rng.integers(1, 3000))
        m = int(rng.integers(1, 1500))
        K = int(rng.integers(1, 5))
        bk = rng.integers(0, K, n).astype(np.int32)
        bs = rng.integers(-1000, 50_000, n).astype(np.int32)
        be = (bs + rng.integers(0, 3000, n)).astype(np.int32)
        if trial % 3 == 0:  # inverted rows force the scan path
            be = np.where(rng.random(n) < 0.1, bs - 100, be).astype(np.int32)
        qk = rng.integers(0, K + 1, m).astype(np.int32)
        qs = rng.integers(-1000, 50_000, m).astype(np.int32)
        qe = (qs + rng.integers(-50, 3000, m)).astype(np.int32)
        idx = native.NativeIntervalIndex(bk, bs, be)
        c, b = idx.coverage(qk, qs, qe)
        ec = np.zeros(m, np.int64)
        eb = np.zeros(m, np.int64)
        for i in range(m):
            sel = (bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i])
            ec[i] = sel.sum()
            if ec[i]:
                eb[i] = (
                    np.minimum(be[sel].astype(np.int64), qe[i])
                    - np.maximum(bs[sel].astype(np.int64), qs[i])
                ).sum()
        np.testing.assert_array_equal(c, ec, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(b, eb, err_msg=f"trial {trial}")
