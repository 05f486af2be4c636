"""Merge-rank emission bounds (ops/merge_count.plan_level_bounds /
merge_level_bounds) — the sort-free device materialization path.

Parity contract: the merge backend's (build_rows, probe_rows) output is
BIT-FOR-BIT identical to the co-sort bounds path (same [lb, ub) per
(probe, level), same probe-major level-minor emission order), for every
query shape — including degenerate stabbing probes and inverted build
intervals, which the BITS count backends must decline but the level-run
identity handles exactly.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from sequila_tpu.config import Algorithm, SequilaConfig
from sequila_tpu.exec.context import ExecContext
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec
from sequila_tpu.exec.plan import ScanExec
from sequila_tpu.models.table import Table
from sequila_tpu.ops.interval_index import build_interval_index
from sequila_tpu.ops.interval_join import materialize_pairs, overlap_bounds
from sequila_tpu.ops import merge_count as mc
from sequila_tpu.planner.expr import BinaryExpr, Column, Literal
from sequila_tpu.planner.intervals import ColInterval, ColIntervals


def _bound(idx, d):
    col = Column("x", idx)
    if d == 0:
        return col
    return BinaryExpr(col, "+" if d > 0 else "-", Literal(abs(d)))


def _join(lt, rt, deltas=(0, 0, 0, 0), **kw):
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
        **kw,
    )


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, neg=False,
            degenerate=0.0, inverted=0.0):
    lo = -span if neg else 0
    lts = rng.integers(lo, span, n).astype(np.int64)
    rts = rng.integers(lo, span, m).astype(np.int64)
    le = lts + rng.integers(2, 3000, n)
    re = rts + rng.integers(2, 3000, m)
    if inverted:
        flip = rng.random(n) < inverted
        le = np.where(flip, lts - rng.integers(1, 500, n), le)
    if degenerate:
        flip = rng.random(m) < degenerate
        re = np.where(flip, rts - rng.integers(1, 500, m), re)
    lt = Table(pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
        "s": lts, "e": le,
    }))
    rt = Table(pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
        "s": rts, "e": re,
    }))
    return lt, rt


def _pairs_via(join, lt, rt, backend, monkeypatch):
    monkeypatch.setenv("SEQUILA_EMIT_BACKEND", backend)
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")  # force device path
    ctx = ExecContext(SequilaConfig())
    out = join.execute(ctx)
    return [tuple(d.values()) for d in out.to_pylist()]


def _merge_bounds(join, lt, rt):
    """(lb, ub) from the merge backend + the index it was planned for."""
    ctx = ExecContext(SequilaConfig())
    index, rcodes, rs, re = join._prepare(ctx, lt, rt)
    plan = join._merge_bounds_plan(lt, rt, index)
    assert plan is not None, "merge bounds plan must engage for this shape"
    lb, ub = mc.merge_level_bounds(plan)
    return index, lb, ub, rcodes, rs, re


class TestMergeBoundsParity:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_bounds_match_cosort(self, rng, deltas):
        """[lb, ub) equals the co-sort rank computation, element-wise."""
        lt, rt = _tables(rng, 400, 700)
        join = _join(lt, rt, deltas)
        index, lb, ub, rcodes, rs, re = _merge_bounds(join, lt, rt)
        m = rt.num_rows
        from sequila_tpu.exec.joins.interval_join import IntervalJoinExec as E

        qk, qs, qe, cap = E._pad_chunk(rcodes, rs, re, 0, m)
        lb2, ub2 = overlap_bounds(index, qk, qs, qe, "sort")
        got_lb = np.asarray(lb)[:, :m]
        got_ub = np.asarray(ub)[:, :m]
        np.testing.assert_array_equal(got_lb, np.asarray(lb2)[:, :m])
        np.testing.assert_array_equal(got_ub, np.asarray(ub2)[:, :m])

    @pytest.mark.parametrize(
        "shape",
        [
            dict(),
            dict(neg=True, lkeys=3, rkeys=9),
            dict(degenerate=0.15),
            dict(inverted=0.15),
            dict(degenerate=0.1, inverted=0.1),
        ],
    )
    def test_execute_bitwise_parity(self, rng, shape, monkeypatch):
        """Full execute() output is bit-identical across backends —
        including degenerate probes and inverted builds (shapes the BITS
        count backends decline; the level-run identity is exact)."""
        lt, rt = _tables(rng, 500, 800, **shape)
        a = _pairs_via(_join(lt, rt), lt, rt, "merge", monkeypatch)
        b = _pairs_via(_join(lt, rt), lt, rt, "cosort", monkeypatch)
        assert len(a) > 0 and a == b

    def test_low_memory_capped_chunks(self, rng, monkeypatch):
        """The capped continuation (low_memory) slices the one bounds
        computation into cap-sized emissions — same rows, same order."""
        lt, rt = _tables(rng, 400, 900)
        a = _pairs_via(
            _join(lt, rt, low_memory=True), lt, rt, "merge", monkeypatch
        )
        b = _pairs_via(
            _join(lt, rt, low_memory=False), lt, rt, "cosort", monkeypatch
        )
        assert len(a) > 0 and a == b

    def test_execute_batches_parity(self, rng, monkeypatch):
        """Streaming batches through the merge route concatenate to the
        whole result."""
        lt, rt = _tables(rng, 300, 800)
        monkeypatch.setenv("SEQUILA_EMIT_BACKEND", "merge")
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        join = _join(lt, rt)
        ctx = ExecContext(SequilaConfig())
        batches = list(join.execute_batches(ctx))
        assert len(batches) >= 1
        got = [tuple(d.values()) for b in batches for d in b.to_pylist()]
        want = _pairs_via(_join(lt, rt), lt, rt, "cosort", monkeypatch)
        assert got == want

    def test_span_overflow_falls_back(self, rng):
        """Coordinates spanning the full int32 range exceed the packed
        32-bit budget: the plan must decline and execute() still answer
        (co-sort fallback)."""
        def wide(nn, seed):
            r = np.random.default_rng(seed)
            s = r.integers(-(2**31) + 10, 2**31 - 2000, nn).astype(np.int64)
            return Table(pa.table({
                "contig": [f"c{int(k)}" for k in r.integers(0, 2, nn)],
                "s": s, "e": s + 1000,
            }))

        lt, rt = wide(300, 1), wide(300, 2)
        join = _join(lt, rt)
        ctx = ExecContext(SequilaConfig())
        index, *_ = join._prepare(ctx, lt, rt)
        assert join._merge_bounds_plan(lt, rt, index) is None

    def test_pairs_match_oracle(self, rng):
        """Merge-route materialize_pairs_from_bounds output equals the
        brute-force pair set (sorted compare)."""
        from sequila_tpu.ops.interval_join import materialize_pairs_from_bounds
        from sequila_tpu.ops.oracle import oracle_pairs

        lt, rt = _tables(rng, 250, 400, degenerate=0.1, inverted=0.1)
        join = _join(lt, rt)
        index, lb, ub, rcodes, rs, re = _merge_bounds(join, lt, rt)
        b, p, total = materialize_pairs_from_bounds(index, lb, ub)
        lk = lt.column_np("contig")
        rk = rt.column_np("contig")
        # joint codes: oracle operates on raw key equality
        ob, op = oracle_pairs(
            np.unique(np.concatenate([lk, rk]), return_inverse=True)[1][: len(lk)].astype(np.int32),
            lt.column_np("s").astype(np.int32), lt.column_np("e").astype(np.int32),
            np.unique(np.concatenate([lk, rk]), return_inverse=True)[1][len(lk):].astype(np.int32),
            rt.column_np("s").astype(np.int32), rt.column_np("e").astype(np.int32),
        )
        assert sorted(zip(p.tolist(), b.tolist())) == sorted(
            zip(op.tolist(), ob.tolist())
        )
