"""Packed-u32 merge-count backend (ops/merge_count.py).

The whole-genome count(*) fast path: ranks the sorted build views inside
the sorted probe views with a vectorized binary search — no device sort.
Parity is asserted against brute force and against the co-sort backend,
including the planner's ±1 strict-op deltas, missing keys, negative
coordinates, and the 32-bit span-budget fallback.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from sequila_tpu.config import Algorithm, SequilaConfig
from sequila_tpu.exec.context import ExecContext
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec
from sequila_tpu.exec.plan import ScanExec
from sequila_tpu.models.table import Table, merge_dictionaries
from sequila_tpu.ops import merge_count as mc
from sequila_tpu.planner.expr import BinaryExpr, Column, Literal
from sequila_tpu.planner.intervals import ColInterval, ColIntervals


def _bound(idx, d):
    col = Column("x", idx)
    if d == 0:
        return col
    return BinaryExpr(col, "+" if d > 0 else "-", Literal(abs(d)))


def _join(lt, rt, deltas=(0, 0, 0, 0)):
    d_bs, d_be, d_qs, d_qe = deltas
    return IntervalJoinExec(
        ScanExec("l", lt), ScanExec("r", rt),
        on=[(Column("contig", 0), Column("contig", 0))],
        filter_=None,
        intervals=ColIntervals(
            ColInterval(_bound(1, d_bs), _bound(2, d_be)),
            ColInterval(_bound(1, d_qs), _bound(2, d_qe)),
        ),
        algorithm=Algorithm.COITREES,
    )


def _brute(lt, rt, deltas):
    d_bs, d_be, d_qs, d_qe = deltas
    lk = lt.column_np("contig")
    ls = lt.column_np("s").astype(np.int64) + d_bs
    le = lt.column_np("e").astype(np.int64) + d_be
    rk = rt.column_np("contig")
    rs = rt.column_np("s").astype(np.int64) + d_qs
    re = rt.column_np("e").astype(np.int64) + d_qe
    return sum(
        int(((lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])).sum())
        for i in range(rt.num_rows)
    )


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, neg=False):
    lo = -span if neg else 0
    lts = rng.integers(lo, span, n).astype(np.int64)
    rts = rng.integers(lo, span, m).astype(np.int64)
    lt = Table(pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
        "s": lts,
        "e": lts + rng.integers(2, 3000, n),
    }))
    rt = Table(pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
        "s": rts,
        "e": rts + rng.integers(2, 3000, m),
    }))
    return lt, rt


class TestMergeCountBackend:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_matches_oracle_with_deltas(self, rng, deltas):
        lt, rt = _tables(rng, 400, 600)
        join = _join(lt, rt, deltas)
        ctx = ExecContext(SequilaConfig())
        got = join._merge_sorted_count(ctx, lt, rt)
        assert got is not None, "merge backend must engage for this shape"
        assert got == _brute(lt, rt, deltas)

    def test_negative_coords_and_missing_keys(self, rng):
        lt, rt = _tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True)
        join = _join(lt, rt)
        got = join._merge_sorted_count(ExecContext(SequilaConfig()), lt, rt)
        assert got is not None
        assert got == _brute(lt, rt, (0, 0, 0, 0))

    def test_probe_larger_and_smaller_than_build(self, rng):
        for n, m in ((2500, 300), (300, 2500)):
            lt, rt = _tables(rng, n, m)
            join = _join(lt, rt)
            got = join._merge_sorted_count(ExecContext(SequilaConfig()), lt, rt)
            assert got is not None
            assert got == _brute(lt, rt, (0, 0, 0, 0))

    def test_span_overflow_falls_back(self, rng):
        """Full-int32-range coordinates across 2 keys exceed the 32-bit
        packing budget: the backend must decline (None), and the operator
        fall through to the co-sort path with the same answer."""
        def wide(nn, seed):
            r = np.random.default_rng(seed)
            s = r.integers(-(2**31), 2**31 - 200, nn).astype(np.int64)
            return Table(pa.table({
                "contig": [f"c{i % 2}" for i in range(nn)],
                "s": s,
                "e": s + 100,
            }))

        lt, rt = wide(500, 1), wide(700, 2)
        join = _join(lt, rt)
        ctx = ExecContext(SequilaConfig())
        assert join._merge_sorted_count(ctx, lt, rt) is None
        assert join._device_resident_count(ctx, lt, rt) is not None

    def test_degenerate_probes_decline(self, rng):
        """qs > qe probe rows break BITS; the sorted-count preconditions
        must route the query away (both sorted backends share them)."""
        lt, _ = _tables(rng, 200, 10)
        rt = Table(pa.table({
            "contig": ["c1"] * 50,
            "s": np.arange(50, dtype=np.int64) + 100,
            "e": np.arange(50, dtype=np.int64),  # inverted: qe < qs
        }))
        join = _join(lt, rt)
        assert join._merge_sorted_count(ExecContext(SequilaConfig()), lt, rt) is None

    def test_single_key_dense_ties(self, rng):
        """Heavy duplicate coordinates on one key exercise tie handling at
        chunk boundaries (rank sides must stay exact under runs)."""
        def dup(nn, seed):
            r = np.random.default_rng(seed)
            s = r.integers(0, 40, nn).astype(np.int64)  # massive ties
            return Table(pa.table({
                "contig": ["k"] * nn,
                "s": s,
                "e": s + r.integers(1, 5, nn),
            }))

        lt, rt = dup(3000, 3), dup(4000, 4)
        join = _join(lt, rt)
        got = join._merge_sorted_count(ExecContext(SequilaConfig()), lt, rt)
        assert got is not None
        assert got == _brute(lt, rt, (0, 0, 0, 0))


def _brute_per_probe(lt, rt, deltas):
    d_bs, d_be, d_qs, d_qe = deltas
    lk = lt.column_np("contig")
    ls = lt.column_np("s").astype(np.int64) + d_bs
    le = lt.column_np("e").astype(np.int64) + d_be
    rk = rt.column_np("contig")
    rs = rt.column_np("s").astype(np.int64) + d_qs
    re = rt.column_np("e").astype(np.int64) + d_qe
    return np.array(
        [
            int(((lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])).sum())
            for i in range(rt.num_rows)
        ],
        np.int64,
    )


class TestMergeProbeCounts:
    """Per-probe direction of the merge backend (CountOverlaps)."""

    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_matches_oracle_with_deltas(self, rng, deltas):
        lt, rt = _tables(rng, 400, 600)
        join = _join(lt, rt, deltas)
        got = join._merge_probe_counts(ExecContext(SequilaConfig()), lt, rt)
        assert got is not None, "merge probe backend must engage"
        np.testing.assert_array_equal(
            got.astype(np.int64), _brute_per_probe(lt, rt, deltas)
        )

    def test_negative_coords_and_missing_keys(self, rng):
        # rkeys > lkeys: probe rows whose key is absent from the build
        # must count 0 (their two ranks are equal)
        lt, rt = _tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True)
        join = _join(lt, rt)
        got = join._merge_probe_counts(ExecContext(SequilaConfig()), lt, rt)
        assert got is not None
        np.testing.assert_array_equal(
            got.astype(np.int64), _brute_per_probe(lt, rt, (0, 0, 0, 0))
        )

    def test_single_key_dense_ties(self, rng):
        def dup(nn, seed):
            r = np.random.default_rng(seed)
            s = r.integers(0, 40, nn).astype(np.int64)
            return Table(pa.table({
                "contig": ["k"] * nn,
                "s": s,
                "e": s + r.integers(1, 5, nn),
            }))

        lt, rt = dup(3000, 3), dup(4000, 4)
        join = _join(lt, rt)
        got = join._merge_probe_counts(ExecContext(SequilaConfig()), lt, rt)
        assert got is not None
        np.testing.assert_array_equal(
            got.astype(np.int64), _brute_per_probe(lt, rt, (0, 0, 0, 0))
        )

    def test_degenerate_probes_decline(self, rng):
        lt, _ = _tables(rng, 200, 10)
        rt = Table(pa.table({
            "contig": ["c1"] * 50,
            "s": np.arange(50, dtype=np.int64) + 100,
            "e": np.arange(50, dtype=np.int64),
        }))
        join = _join(lt, rt)
        assert (
            join._merge_probe_counts(ExecContext(SequilaConfig()), lt, rt)
            is None
        )

    def test_per_probe_counts_device_route(self, rng, monkeypatch):
        """per_probe_counts with the host route disabled goes through the
        merge backend and must equal the host index bit-for-bit."""
        lt, rt = _tables(rng, 1200, 1500)
        join = _join(lt, rt)
        monkeypatch.setattr(IntervalJoinExec, "_use_host", lambda *a, **k: False)
        ctx = ExecContext(SequilaConfig())
        got = join.per_probe_counts(ctx)
        np.testing.assert_array_equal(
            np.asarray(got, np.int64), _brute_per_probe(lt, rt, (0, 0, 0, 0))
        )

    def test_sorted_interval_order_roundtrip(self, rng):
        lt, _ = _tables(rng, 512, 8)
        order = lt.sorted_interval_order(0, 1)
        _, _, kh, vh, n = lt.sorted_interval_view(0, 1)
        codes, _, _ = lt.dict_codes(0)
        vals = lt.column_as_i32(1)
        np.testing.assert_array_equal(kh[:n], codes[order])
        np.testing.assert_array_equal(vh[:n], vals[order])
        assert len(order) == lt.num_rows


class TestMergeVerbBackend:
    """Verb-layer merge rank passes: count_overlaps + coverage."""

    @staticmethod
    def _rename(t):
        return Table(t.arrow.rename_columns(["contig", "pos_start", "pos_end"]))

    def _brute_cov(self, lt, rt):
        lk = lt.column_np("contig")
        ls = lt.column_np("pos_start").astype(np.int64)
        le = lt.column_np("pos_end").astype(np.int64)
        rk = rt.column_np("contig")
        rs = rt.column_np("pos_start").astype(np.int64)
        re = rt.column_np("pos_end").astype(np.int64)
        counts = np.zeros(rt.num_rows, np.int64)
        bases = np.zeros(rt.num_rows, np.int64)
        for i in range(rt.num_rows):
            sel = (lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])
            counts[i] = int(sel.sum())
            bases[i] = int(
                (np.minimum(le[sel], re[i]) - np.maximum(ls[sel], rs[i])).sum()
            )
        return counts, bases

    def test_count_overlaps_device_merge(self, rng, monkeypatch):
        from sequila_tpu import dataframe as gdf

        lt, rt = _tables(rng, 900, 1100)
        a, b = self._rename(rt), self._rename(lt)  # enrich a with b-counts
        monkeypatch.setattr(gdf, "_route_perprobe_host", lambda *x: False)
        out = gdf.count_overlaps(a, b)
        expect, _ = self._brute_cov(b, a)
        np.testing.assert_array_equal(out.column_np("count"), expect)

    def test_coverage_device_merge(self, rng, monkeypatch):
        from sequila_tpu import dataframe as gdf

        lt, rt = _tables(rng, 900, 1100, lkeys=4, rkeys=7)
        a, b = self._rename(rt), self._rename(lt)
        monkeypatch.setattr(gdf, "_route_perprobe_host", lambda *x: False)
        # assert the merge plan actually engages for this shape
        from sequila_tpu.ops import merge_count as mc

        ib = (0, 1, 2)
        assert mc.plan_verb_ranks(b, a, ib, ib, want4=True) is not None
        out = gdf.coverage(a, b)
        expect_c, expect_b = self._brute_cov(b, a)
        np.testing.assert_array_equal(out.column_np("count"), expect_c)
        np.testing.assert_array_equal(out.column_np("bases"), expect_b)

    def test_coverage_negative_coords(self, rng, monkeypatch):
        from sequila_tpu import dataframe as gdf

        lt, rt = _tables(rng, 700, 500, neg=True)
        a, b = self._rename(rt), self._rename(lt)
        monkeypatch.setattr(gdf, "_route_perprobe_host", lambda *x: False)
        out = gdf.coverage(a, b)
        expect_c, expect_b = self._brute_cov(b, a)
        np.testing.assert_array_equal(out.column_np("count"), expect_c)
        np.testing.assert_array_equal(out.column_np("bases"), expect_b)

    def test_degenerate_declines_and_fallback_correct(self, rng, monkeypatch):
        """Degenerate probe rows must decline the merge plan; the verb
        falls back to the exact kernels with the right answer."""
        from sequila_tpu import dataframe as gdf
        from sequila_tpu.ops import merge_count as mc

        lt, _ = _tables(rng, 300, 10)
        b = self._rename(lt)
        a = Table(pa.table({
            "contig": ["c1"] * 40,
            "pos_start": np.arange(40, dtype=np.int64) + 50,
            "pos_end": np.arange(40, dtype=np.int64),  # qs > qe
        }))
        assert mc.plan_verb_ranks(b, a, (0, 1, 2), (0, 1, 2), want4=True) is None
        monkeypatch.setattr(gdf, "_route_perprobe_host", lambda *x: False)
        out = gdf.coverage(a, b)
        expect_c, expect_b = self._brute_cov(b, a)
        np.testing.assert_array_equal(out.column_np("count"), expect_c)
        np.testing.assert_array_equal(out.column_np("bases"), expect_b)

    def test_strand_folding_bypasses_merge(self, rng, monkeypatch):
        """strand='same' rewrites the key column — the merge plan must not
        engage, and the folded result must stay correct."""
        from sequila_tpu import dataframe as gdf

        lt, rt = _tables(rng, 400, 300, lkeys=2, rkeys=2)
        a, b = self._rename(rt), self._rename(lt)
        sa = np.where(np.arange(a.num_rows) % 2 == 0, "+", "-")
        sb = np.where(np.arange(b.num_rows) % 3 == 0, "+", "-")
        a = Table(a.arrow.append_column("strand", pa.array(sa)))
        b = Table(b.arrow.append_column("strand", pa.array(sb)))
        monkeypatch.setattr(gdf, "_route_perprobe_host", lambda *x: False)
        out = gdf.count_overlaps(a, b, strand="same")
        lk = np.char.add(b.column_np("contig").astype("U8"), sb)
        rk = np.char.add(a.column_np("contig").astype("U8"), sa)
        ls = b.column_np("pos_start").astype(np.int64)
        le = b.column_np("pos_end").astype(np.int64)
        rs = a.column_np("pos_start").astype(np.int64)
        re = a.column_np("pos_end").astype(np.int64)
        expect = np.array([
            int(((lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])).sum())
            for i in range(a.num_rows)
        ])
        np.testing.assert_array_equal(out.column_np("count"), expect)


class TestMergeCountPieces:
    def test_per_key_minmax(self, rng):
        n = 1000
        k = rng.integers(0, 7, n)
        v = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int64)
        t = Table(pa.table({
            "contig": [f"c{int(x)}" for x in k],
            "v": v,
        }))
        mins, maxs = t.per_key_minmax(0, 1)
        codes, values, _ = t.dict_codes(0)
        for c in range(len(values)):
            sel = v[codes == c]
            assert mins[c] == sel.min()
            assert maxs[c] == sel.max()

    def test_plan_packing_span_budget(self):
        """Spans just inside / outside the 32-bit budget."""
        remap_b = np.array([0, 1], np.int32)
        remap_q = np.array([0, 1], np.int32)
        half = (2**31) - 2
        views_ok = tuple(
            (np.array([0, 0], np.int64), np.array([half - 1, half - 1], np.int64))
            for _ in range(4)
        )
        assert mc.plan_packing(remap_b, remap_q, views_ok, (0, 0, 0, 0)) is not None
        views_over = tuple(
            (np.array([0, 0], np.int64), np.array([half + 2, half + 2], np.int64))
            for _ in range(4)
        )
        assert mc.plan_packing(remap_b, remap_q, views_over, (0, 0, 0, 0)) is None

    @pytest.mark.parametrize("strict", [True, False])
    def test_merge_rank_sorted_parity(self, rng, strict):
        """The rank primitive == np.searchsorted on u32 domains."""
        n, m = 4096, 6144
        a_h = np.sort(rng.integers(0, 2**32 - 3, m, dtype=np.uint32))
        q_h = np.sort(rng.integers(0, 2**32 - 3, n, dtype=np.uint32))
        got = np.asarray(
            mc._rank_sorted(jnp.asarray(a_h), jnp.asarray(q_h), strict=strict)
        )
        side = "left" if strict else "right"
        np.testing.assert_array_equal(got, np.searchsorted(a_h, q_h, side=side))


def _padded(vals, n_pad, sentinel):
    out = np.full(n_pad, sentinel, np.uint32)
    out[: len(vals)] = np.sort(np.asarray(vals, np.uint32))
    return out


def _rank_cases():
    r = np.random.default_rng(7)
    hi = r.integers(2**31, 2**32 - 2, 3000, dtype=np.uint32)
    dup_table = np.concatenate([
        r.integers(0, 1000, 700), np.full(3000, 5000), r.integers(6000, 9000, 900),
    ])
    return {
        # one value repeated across many 512-row blocks, queried at,
        # just below and just above the run
        "giant_duplicate_run": (
            _padded(dup_table, 6144, mc._PROBE_PAD),
            np.array([4999, 5000, 5000, 5001, 0, 9000], np.uint32),
        ),
        # a table filling its padded length exactly: no PAD tail at all
        "aligned_no_pad_tail": (
            np.sort(r.integers(0, 2**32 - 2, 2048, dtype=np.uint32)),
            np.sort(r.integers(0, 2**32 - 2, 512, dtype=np.uint32)),
        ),
        # queries that are all build PAD: they rank the whole table,
        # probe PAD slots included
        "all_pad_queries": (
            _padded(r.integers(0, 10**6, 100), 2048, mc._PROBE_PAD),
            np.full(256, mc._BUILD_PAD, np.uint32),
        ),
        "empty_queries": (
            _padded(r.integers(0, 10**6, 100), 2048, mc._PROBE_PAD),
            np.zeros(0, np.uint32),
        ),
        # a table of PAD slots only (an empty side after padding)
        "all_pad_table": (
            np.full(2048, mc._PROBE_PAD, np.uint32),
            np.sort(r.integers(0, 2**32 - 2, 300, dtype=np.uint32)),
        ),
        # packed values above 2^31 must compare unsigned, with both PAD
        # sentinels present on their sides
        "above_2_31_with_pads": (
            _padded(hi, 4096, mc._PROBE_PAD),
            np.concatenate([
                np.sort(r.integers(2**31 - 5, 2**32 - 2, 700, dtype=np.uint32)),
                np.full(68, mc._BUILD_PAD, np.uint32),
            ]),
        ),
    }


_RANK_CASES = _rank_cases()


class TestRankSorted:
    """The kept rank form (jnp.searchsorted over packed u32) against
    np.searchsorted, on the edge shapes the padded sorted views produce."""

    @pytest.mark.parametrize("strict", [True, False])
    @pytest.mark.parametrize("case", sorted(_RANK_CASES))
    def test_matches_numpy(self, case, strict):
        a_h, q_h = _RANK_CASES[case]
        assert (np.diff(a_h.astype(np.int64)) >= 0).all()
        got = np.asarray(
            mc._rank_sorted(jnp.asarray(a_h), jnp.asarray(q_h), strict=strict)
        )
        side = "left" if strict else "right"
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.searchsorted(a_h, q_h, side=side))

    def test_partials_total_exact_past_int32(self):
        """Per-64 partials keep the two-pass total exact when the summed
        ranks exceed int32 (the host finishes in int64)."""
        m_pad = (1 << 25) - 64
        r1 = jnp.full((4096,), m_pad, jnp.int32)
        r2 = jnp.zeros((4096,), jnp.int32).at[:64].set(1)
        parts = np.asarray(jnp.stack([mc.rank_partials(r1), mc.rank_partials(r2)]))
        assert mc.partials_to_total(parts) == 4096 * m_pad - 64
