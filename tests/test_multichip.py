"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The reference has NO test coverage for its Partitioned mode (SURVEY.md §4);
these tests exceed it: partitioned and collect-left SPMD counts must equal
the single-chip kernel and the brute-force oracle.
"""

import numpy as np
import pytest

import jax

from sequila_tpu.ops.oracle import oracle_counts
from sequila_tpu.parallel.mesh import make_mesh
from sequila_tpu.parallel.partitioned_join import (
    collect_left_count,
    partitioned_count,
)


def _tables(rng, n, m, num_keys=7):
    lk = rng.integers(0, num_keys, n).astype(np.int32)
    ls = rng.integers(0, 10_000, n).astype(np.int32)
    le = ls + rng.integers(0, 500, n).astype(np.int32)
    rk = rng.integers(0, num_keys + 2, m).astype(np.int32)
    rs = rng.integers(0, 10_000, m).astype(np.int32)
    re = rs + rng.integers(0, 500, m).astype(np.int32)
    return lk, ls, le, rk, rs, re


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("part", [1, 2, 4, 8])
def test_partitioned_count_matches_oracle(rng, part):
    mesh = make_mesh(8, part=part)
    lk, ls, le, rk, rs, re = _tables(rng, 500, 700)
    want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
    got = partitioned_count(mesh, lk, ls, le, rk, rs, re)
    assert got == want


def test_collect_left_count_matches_oracle(rng):
    mesh = make_mesh(8, part=2)
    lk, ls, le, rk, rs, re = _tables(rng, 300, 900)
    want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
    got = collect_left_count(mesh, lk, ls, le, rk, rs, re)
    assert got == want


def test_partitioned_empty_sides(rng):
    mesh = make_mesh(4, part=2)
    lk, ls, le, rk, rs, re = _tables(rng, 100, 50)
    assert partitioned_count(
        mesh, lk[:0], ls[:0], le[:0], rk, rs, re
    ) == 0
    assert partitioned_count(
        mesh, lk, ls, le, rk[:0], rs[:0], re[:0]
    ) == 0


def test_skewed_keys(rng):
    """One hot contig (the chr1-skew scenario): partitioning must stay
    exact when one part holds most of the data."""
    mesh = make_mesh(8, part=4)
    n, m = 400, 600
    lk = np.where(rng.random(n) < 0.9, 0, rng.integers(0, 8, n)).astype(np.int32)
    ls = rng.integers(0, 5_000, n).astype(np.int32)
    le = ls + rng.integers(0, 400, n).astype(np.int32)
    rk = np.where(rng.random(m) < 0.9, 0, rng.integers(0, 8, m)).astype(np.int32)
    rs = rng.integers(0, 5_000, m).astype(np.int32)
    re = rs + rng.integers(0, 400, m).astype(np.int32)
    want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
    assert partitioned_count(mesh, lk, ls, le, rk, rs, re) == want
    assert collect_left_count(mesh, lk, ls, le, rk, rs, re) == want


@pytest.mark.parametrize("part", [2, 4])
def test_partitioned_pairs_match_oracle(rng, part):
    """Distributed materializing join == brute-force oracle pairs."""
    from sequila_tpu.ops.oracle import oracle_pairs
    from sequila_tpu.parallel.partitioned_join import partitioned_pairs

    mesh = make_mesh(8, part=part)
    lk, ls, le, rk, rs, re = _tables(rng, 300, 400)
    b, p = partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
    ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
    assert sorted(zip(p.tolist(), b.tolist())) == sorted(
        zip(op.tolist(), ob.tolist())
    )


class TestSkewAware:
    def test_skew_split_count_exact(self, rng):
        """90% of rows on one contig: range-split counts must stay exact."""
        from sequila_tpu.parallel.skew import plan_partitions, skew_partitioned_count

        n, m = 800, 1000
        lk = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 6, n)).astype(np.int32)
        ls = rng.integers(0, 50_000, n).astype(np.int32)
        le = ls + rng.integers(0, 2_000, n).astype(np.int32)
        rk = np.where(rng.random(m) < 0.9, 0, rng.integers(1, 6, m)).astype(np.int32)
        rs = rng.integers(0, 50_000, m).astype(np.int32)
        re = rs + rng.integers(0, 2_000, m).astype(np.int32)
        plan = plan_partitions(lk, rk, rs, npart=8)
        assert 0 in plan.splits, "hot contig must be range-split"
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        got = skew_partitioned_count(lk, ls, le, rk, rs, re, npart=8)
        assert got == want

    def test_single_key_everything(self, rng):
        """All rows one contig (the reference's chr1-only benchmark shape)."""
        from sequila_tpu.parallel.skew import skew_partitioned_count

        n, m = 500, 600
        lk = np.zeros(n, np.int32)
        ls = rng.integers(0, 100_000, n).astype(np.int32)
        le = ls + rng.integers(0, 5_000, n).astype(np.int32)
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        re = rs + rng.integers(0, 5_000, m).astype(np.int32)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert skew_partitioned_count(lk, ls, le, rk, rs, re, npart=8) == want

    def test_long_straddling_intervals(self, rng):
        """Intervals spanning many sub-ranges (replicated everywhere) must
        be counted exactly once per matching pair."""
        from sequila_tpu.parallel.skew import skew_partitioned_count

        n = 50
        lk = np.zeros(n, np.int32)
        ls = np.zeros(n, np.int32)  # all start at 0
        le = np.full(n, 99_999, np.int32)  # all span everything
        m = 300
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        re = rs + rng.integers(0, 100, m).astype(np.int32)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert want == n * m  # sanity: every pair overlaps
        assert skew_partitioned_count(lk, ls, le, rk, rs, re, npart=4) == want

    def test_balanced_load(self, rng):
        """The plan must spread a hot contig across parts."""
        from sequila_tpu.parallel.skew import assign_probe, plan_partitions

        m = 2000
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 1_000_000, m).astype(np.int32)
        lk = np.zeros(500, np.int32)
        plan = plan_partitions(lk, rk, rs, npart=8)
        sid, row, lo, hi = assign_probe(plan, rk, rs, rs + 100)
        parts = plan.shard_part[sid]
        loads = np.bincount(parts, minlength=8)
        assert loads.max() <= 2.5 * max(loads[loads > 0].min(), 1)

    def test_skew_mesh_count(self, rng):
        """SPMD skew-aware count on the virtual mesh == oracle."""
        from sequila_tpu.parallel.skew import skew_partitioned_count_mesh

        mesh = make_mesh(8, part=4)
        n, m = 600, 800
        lk = np.where(rng.random(n) < 0.85, 0, rng.integers(1, 5, n)).astype(np.int32)
        ls = rng.integers(0, 40_000, n).astype(np.int32)
        le = ls + rng.integers(0, 3_000, n).astype(np.int32)
        rk = np.where(rng.random(m) < 0.85, 0, rng.integers(1, 5, m)).astype(np.int32)
        rs = rng.integers(0, 40_000, m).astype(np.int32)
        re = rs + rng.integers(0, 3_000, m).astype(np.int32)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert skew_partitioned_count_mesh(mesh, lk, ls, le, rk, rs, re) == want

    def test_duplicate_probe_starts_dont_crash_split(self):
        """Hot contig whose probes share few distinct starts (duplicate
        quantiles) must still plan and count exactly."""
        from sequila_tpu.ops.oracle import oracle_counts
        from sequila_tpu.parallel.skew import skew_partitioned_count

        m = 2000
        rk = np.zeros(m, np.int32)
        rs = np.where(np.arange(m) % 2 == 0, 100, 200).astype(np.int32)
        re = rs + 50
        lk = np.zeros(300, np.int32)
        ls = np.linspace(0, 400, 300).astype(np.int32)
        le = ls + 30
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert skew_partitioned_count(lk, ls, le, rk, rs, re, npart=8) == want

    def test_single_distinct_start_keeps_key_whole(self):
        from sequila_tpu.ops.oracle import oracle_counts
        from sequila_tpu.parallel.skew import skew_partitioned_count

        m = 500
        rk = np.zeros(m, np.int32)
        rs = np.full(m, 42, np.int32)
        re = rs + 10
        lk = np.zeros(100, np.int32)
        ls = np.arange(100, dtype=np.int32)
        le = ls + 5
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert skew_partitioned_count(lk, ls, le, rk, rs, re, npart=8) == want

    def test_skew_pairs_match_oracle(self, rng):
        """Skew-aware SPMD MATERIALIZATION: replicated rows must not
        produce duplicate pairs; result == brute-force oracle."""
        from sequila_tpu.ops.oracle import oracle_pairs
        from sequila_tpu.parallel.skew import skew_partitioned_pairs

        mesh = make_mesh(8, part=4)
        n, m = 300, 500
        lk = np.where(rng.random(n) < 0.85, 0, rng.integers(1, 5, n)).astype(np.int32)
        ls = rng.integers(0, 20_000, n).astype(np.int32)
        le = ls + rng.integers(0, 3_000, n).astype(np.int32)
        rk = np.where(rng.random(m) < 0.85, 0, rng.integers(1, 5, m)).astype(np.int32)
        rs = rng.integers(0, 20_000, m).astype(np.int32)
        re = rs + rng.integers(0, 3_000, m).astype(np.int32)
        b, p = skew_partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
        assert sorted(zip(p.tolist(), b.tolist())) == sorted(
            zip(op.tolist(), ob.tolist())
        )

    def test_skew_pairs_long_straddlers(self, rng):
        from sequila_tpu.ops.oracle import oracle_pairs
        from sequila_tpu.parallel.skew import skew_partitioned_pairs

        mesh = make_mesh(4, part=2)
        n = 40
        lk = np.zeros(n, np.int32)
        ls = np.zeros(n, np.int32)
        le = np.full(n, 99_999, np.int32)
        m = 200
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        re = rs + rng.integers(0, 100, m).astype(np.int32)
        b, p = skew_partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        assert len(b) == n * m
        ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
        assert sorted(zip(p.tolist(), b.tolist())) == sorted(
            zip(op.tolist(), ob.tolist())
        )


class TestSkewNearest:
    """Skew range-split NEAREST (VERDICT r3 item 7): hot contigs no longer
    serialize nearest queries.  Exactness rests on canonical tie-breaking
    plus per-boundary fringe replication (parallel/skew.py)."""

    @staticmethod
    def _skewed(rng, n, m, span=50_000, maxlen=800, hot=0.9, keys=6):
        lk = np.where(rng.random(n) < hot, 0, rng.integers(1, keys, n)).astype(np.int32)
        ls = rng.integers(0, span, n).astype(np.int32)
        le = ls + rng.integers(0, maxlen, n).astype(np.int32)
        rk = np.where(rng.random(m) < hot, 0, rng.integers(1, keys + 2, m)).astype(np.int32)
        rs = rng.integers(0, span, m).astype(np.int32)
        re = rs + rng.integers(0, maxlen, m).astype(np.int32)
        return lk, ls, le, rk, rs, re

    def test_skew_nearest_matches_canonical_oracle(self, rng):
        from sequila_tpu.ops.oracle import oracle_nearest_canonical
        from sequila_tpu.parallel.skew import (
            plan_partitions,
            skew_partitioned_nearest,
        )

        mesh = make_mesh(8, part=4)
        lk, ls, le, rk, rs, re = self._skewed(rng, 400, 700)
        plan = plan_partitions(lk, rk, rs, npart=4)
        assert 0 in plan.splits, "hot contig must be range-split"
        want = oracle_nearest_canonical(lk, ls, le, rk, rs, re)
        got = skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(got, want)

    def test_skew_nearest_matches_hash_partitioned(self, rng):
        """Skew and hash distributions must agree bit-for-bit (the
        canonical-pick guarantee, not just distance equality)."""
        from sequila_tpu.parallel.partitioned_join import partitioned_nearest
        from sequila_tpu.parallel.skew import skew_partitioned_nearest

        mesh = make_mesh(8, part=4)
        lk, ls, le, rk, rs, re = self._skewed(rng, 350, 600, maxlen=2_000)
        np.testing.assert_array_equal(
            skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re),
            partitioned_nearest(mesh, lk, ls, le, rk, rs, re),
        )

    def test_skew_nearest_ties_across_boundaries(self, rng):
        """Duplicate (start,end) intervals + sparse gaps: the canonical
        row pick must survive replication and fringe rows."""
        from sequila_tpu.ops.oracle import oracle_nearest_canonical
        from sequila_tpu.parallel.skew import skew_partitioned_nearest

        mesh = make_mesh(8, part=4)
        n, m = 300, 800
        lk = np.zeros(n, np.int32)
        # few distinct coordinates -> lots of exact duplicates and ties
        ls = rng.integers(0, 40, n).astype(np.int32) * 1_000
        le = ls + rng.integers(0, 4, n).astype(np.int32) * 250
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 40_000, m).astype(np.int32)
        re = rs + rng.integers(0, 300, m).astype(np.int32)
        want = oracle_nearest_canonical(lk, ls, le, rk, rs, re)
        got = skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(got, want)

    def test_skew_nearest_crossing_probes(self, rng):
        """Probes spanning several sub-range cuts (host-answered) and
        gap-heavy build layout: still exactly canonical."""
        from sequila_tpu.ops.oracle import oracle_nearest_canonical
        from sequila_tpu.parallel.skew import (
            assign_probe_nearest,
            plan_partitions,
            skew_partitioned_nearest,
        )

        mesh = make_mesh(8, part=4)
        n, m = 200, 900
        lk = np.zeros(n, np.int32)
        ls = rng.integers(0, 100_000, n).astype(np.int32)
        le = ls + rng.integers(0, 500, n).astype(np.int32)
        rk = np.zeros(m, np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        # half the probes are LONG (span multiple probe-start quantiles)
        long = rng.random(m) < 0.5
        re = rs + np.where(long, rng.integers(20_000, 80_000, m), rng.integers(0, 200, m)).astype(np.int32)
        plan = plan_partitions(lk, rk, rs, npart=4)
        assert 0 in plan.splits
        _, _, crossing = assign_probe_nearest(plan, rk, rs, re)
        assert len(crossing) > 0, "test must exercise the crossing path"
        want = oracle_nearest_canonical(lk, ls, le, rk, rs, re)
        got = skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(got, want)

    def test_skew_nearest_fringe_only_shards(self):
        """Sub-ranges with NO native builds must fall back to the fringe
        rows (upstream below lo / downstream at hi)."""
        from sequila_tpu.ops.oracle import oracle_nearest_canonical
        from sequila_tpu.parallel.skew import skew_partitioned_nearest

        mesh = make_mesh(8, part=4)
        # builds clustered at the far left and far right only
        ls = np.concatenate([
            np.arange(5, dtype=np.int32),
            np.arange(90_000, 90_005, dtype=np.int32),
        ])
        le = ls + 3
        lk = np.zeros(len(ls), np.int32)
        # probes spread across the whole (build-empty) middle
        m = 600
        rs = np.linspace(100, 89_000, m).astype(np.int32)
        re = rs + 7
        rk = np.zeros(m, np.int32)
        want = oracle_nearest_canonical(lk, ls, le, rk, rs, re)
        got = skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(got, want)

    def test_skew_nearest_absent_and_build_free_keys(self, rng):
        """Probe keys with no builds anywhere -> -1, even when hot."""
        from sequila_tpu.ops.oracle import oracle_nearest_canonical
        from sequila_tpu.parallel.skew import skew_partitioned_nearest

        mesh = make_mesh(8, part=4)
        n, m = 100, 500
        lk = rng.integers(0, 2, n).astype(np.int32)  # builds on keys 0-1
        ls = rng.integers(0, 10_000, n).astype(np.int32)
        le = ls + rng.integers(0, 300, n).astype(np.int32)
        # probes 90% on key 7 (hot AND build-free), rest on 0-3
        rk = np.where(rng.random(m) < 0.9, 7, rng.integers(0, 4, m)).astype(np.int32)
        rs = rng.integers(0, 10_000, m).astype(np.int32)
        re = rs + rng.integers(0, 300, m).astype(np.int32)
        want = oracle_nearest_canonical(lk, ls, le, rk, rs, re)
        got = skew_partitioned_nearest(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(got, want)
        assert (got[rk == 7] == -1).all()


class TestDeviceShuffle:
    def test_all_to_all_count_matches_oracle(self, rng):
        """REAL device-side all_to_all shuffle + shard-local count."""
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_count

        mesh = make_mesh(8, part=8)
        lk, ls, le, rk, rs, re = _tables(rng, 500, 700)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        got = all_to_all_partitioned_count(mesh, lk, ls, le, rk, rs, re)
        assert got == want

    def test_all_to_all_skewed(self, rng):
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_count

        mesh = make_mesh(4, part=4)
        n, m = 300, 400
        lk = np.where(rng.random(n) < 0.8, 3, rng.integers(0, 8, n)).astype(np.int32)
        ls = rng.integers(0, 9_000, n).astype(np.int32)
        le = ls + rng.integers(0, 700, n).astype(np.int32)
        rk = np.where(rng.random(m) < 0.8, 3, rng.integers(0, 8, m)).astype(np.int32)
        rs = rng.integers(0, 9_000, m).astype(np.int32)
        re = rs + rng.integers(0, 700, m).astype(np.int32)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        assert all_to_all_partitioned_count(mesh, lk, ls, le, rk, rs, re) == want

    def test_all_to_all_empty_and_tiny(self, rng):
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_count

        mesh = make_mesh(4, part=4)
        lk = np.array([0], np.int32)
        ls = np.array([5], np.int32)
        le = np.array([10], np.int32)
        rk = np.array([0, 1], np.int32)
        rs = np.array([7, 7], np.int32)
        re = np.array([8, 8], np.int32)
        assert all_to_all_partitioned_count(mesh, lk, ls, le, rk, rs, re) == 1

    def test_all_to_all_pairs_match_oracle(self, rng):
        """Device-shuffled MATERIALIZING join == oracle pairs."""
        from sequila_tpu.ops.oracle import oracle_pairs
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_pairs

        mesh = make_mesh(8, part=8)
        lk, ls, le, rk, rs, re = _tables(rng, 300, 450)
        b, q = all_to_all_partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
        assert sorted(zip(q.tolist(), b.tolist())) == sorted(
            zip(op.tolist(), ob.tolist())
        )

    def test_all_to_all_pairs_capacity_regrow(self, rng):
        """Dense data must trigger the capacity re-run and stay exact."""
        from sequila_tpu.ops.oracle import oracle_pairs
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_pairs

        mesh = make_mesh(4, part=4)
        n = 120
        lk = np.zeros(n, np.int32)
        ls = np.arange(n, dtype=np.int32)
        le = ls + 10_000
        rk = np.zeros(n, np.int32)
        rs = np.arange(n, dtype=np.int32)
        re = rs + 10_000
        b, q = all_to_all_partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        assert len(b) == n * n
        ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
        assert sorted(zip(q.tolist(), b.tolist())) == sorted(
            zip(op.tolist(), ob.tolist())
        )


def test_all_to_all_count_pipelined_chunks():
    """chunks>1 splits the probe exchange into independent slices (the
    shuffle/compute-overlap pipeline); results are identical for any
    chunk count."""
    import numpy as np

    from sequila_tpu.ops.oracle import oracle_counts
    from sequila_tpu.parallel.mesh import make_mesh
    from sequila_tpu.parallel.shuffle import all_to_all_partitioned_count

    rng = np.random.default_rng(3)
    n, m = 300, 700
    lk = rng.integers(0, 4, n).astype(np.int32)
    ls = rng.integers(0, 8000, n).astype(np.int32)
    le = ls + rng.integers(0, 150, n).astype(np.int32)
    rk = rng.integers(0, 5, m).astype(np.int32)
    rs = rng.integers(0, 8000, m).astype(np.int32)
    re = rs + rng.integers(0, 150, m).astype(np.int32)
    mesh = make_mesh(8, part=8)
    want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
    for chunks in (1, 2, 3, 4):
        assert all_to_all_partitioned_count(
            mesh, lk, ls, le, rk, rs, re, chunks=chunks
        ) == want


class TestMeshBoundsStrategy:
    """Per-shard rank strategy routing (SEQUILA_MESH_BOUNDS): the sort-free
    bsearch strategy (the default on every backend) must be bit-identical
    to the co-sort across the mesh entry points."""

    def test_auto_resolves_bsearch_on_cpu(self):
        from sequila_tpu.parallel.partitioned_join import mesh_bounds_strategy

        assert mesh_bounds_strategy() == "bsearch"

    @pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
    def test_default_ignores_backend_name(self, backend, monkeypatch):
        """The default is one measured choice, not a branch on the
        backend's name; only SEQUILA_MESH_BOUNDS changes it."""
        import jax

        from sequila_tpu.parallel.partitioned_join import mesh_bounds_strategy

        monkeypatch.delenv("SEQUILA_MESH_BOUNDS", raising=False)
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert mesh_bounds_strategy() == "bsearch"
        monkeypatch.setenv("SEQUILA_MESH_BOUNDS", "sort")
        assert mesh_bounds_strategy() == "sort"

    @pytest.mark.parametrize("entry", ["count", "pairs", "probe_counts",
                                       "nearest", "coverage"])
    def test_sort_bsearch_parity(self, rng, entry, monkeypatch):
        from sequila_tpu.parallel.partitioned_join import (
            partitioned_coverage,
            partitioned_nearest,
            partitioned_pairs,
            partitioned_probe_counts,
        )

        mesh = make_mesh(8, part=4)
        lk, ls, le, rk, rs, re = _tables(rng, 600, 800)
        fns = {
            "count": lambda: partitioned_count(mesh, lk, ls, le, rk, rs, re),
            "pairs": lambda: partitioned_pairs(mesh, lk, ls, le, rk, rs, re),
            "probe_counts": lambda: partitioned_probe_counts(
                mesh, lk, ls, le, rk, rs, re),
            "nearest": lambda: partitioned_nearest(mesh, lk, ls, le, rk, rs, re),
            "coverage": lambda: partitioned_coverage(mesh, lk, ls, le, rk, rs, re),
        }
        monkeypatch.setenv("SEQUILA_MESH_BOUNDS", "sort")
        a = fns[entry]()
        monkeypatch.setenv("SEQUILA_MESH_BOUNDS", "bsearch")
        b = fns[entry]()
        flat = lambda x: [np.asarray(v).tolist() for v in (x if isinstance(x, tuple) else (x,))]
        assert flat(a) == flat(b)
