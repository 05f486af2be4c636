"""IntervalJoinExec — the engine's flagship operator.

Role-equivalent of the reference's IntervalJoinExec (reference
joins/interval_join.rs:71-594): a build/probe range-overlap join keyed on
equi-columns.  Build side = LEFT (collected once, like CollectLeft +
OnceAsync, interval_join.rs:472-487); probe side = RIGHT, processed in
bounded chunks (the analog of the reference's streamed probe batches and
SEQUILA_MAX_OUTPUT_BATCH_SIZE-capped low-memory emission,
interval_join.rs:1236-1336).

The per-row tree queries of the reference are replaced by the batched device
kernels of ops/interval_join.py over the level-decomposed index of
ops/interval_index.py; output is take(left) ++ take(right) exactly as the
reference's emit paths.

Semantics parity contract:
- end-inclusive i32 intervals; strict </> already normalized to `end - 1`
  expressions by the planner (planner/intervals.py);
- i32 cast overflow is a hard error (interval_join.rs:1661-1672);
- Nearest: one output row per probe row, NULL-padded left side when the
  equi-key is absent from the build side;
- probe-side row order is preserved (reference: probe side is always Right
  and its order is maintained, interval_join.rs:210-224).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

import jax
import jax.numpy as jnp

from sequila_tpu.config import Algorithm
from sequila_tpu.errors import ExecutionError
from sequila_tpu.exec.joins.utils import (
    JOIN_TYPE_DISPLAY,
    display_on,
    finish_join,
    gather_join_output,
    join_schema,
)
from sequila_tpu.exec.plan import ExecPlan
from sequila_tpu.models.table import Table, encode_join_keys
from sequila_tpu.ops.interval_index import PAD_KEY, PAD_VAL, build_interval_index, _bucket
from sequila_tpu.ops.interval_join import (
    count_matches,
    materialize_pairs,
    nearest_match,
    total_count_i64,
)
from sequila_tpu.planner.expr import JoinFilter, Literal, PhysicalExpr
from sequila_tpu.planner.intervals import ColIntervals

# Probe rows per device chunk in full (non-low-memory) mode.
_FULL_MODE_CHUNK = 4 << 20

# Build sides at/above this row count skip the fused BITS 64-bucket
# partials (which could overflow int32) and use the exact chunked level
# path instead.  Module constant so stress tests can lower it.
_BITS_PARTIALS_MAX = 1 << 24

import os as _os


def _host_threshold() -> int:
    """Below this many total rows the join runs on the host path (NumPy /
    C++): XLA compile latency dwarfs tiny queries.  SEQUILA_HOST_THRESHOLD=0 forces the device path everywhere."""
    return int(_os.environ.get("SEQUILA_HOST_THRESHOLD", 65536))

def nearest_route_host(n: int, m: int) -> bool:
    """Host-vs-device routing for NEAREST (one output row per probe row).

    The pair cost model doesn't fit nearest: the device ships only 8
    bytes/probe, but its bounds pass co-sorts (n + L*m) rows AND the
    device index build pays a host np.lexsort over n rows, while the
    native host index answers nearest with two segment searches per
    probe off a radix-built index.  Measured through SQL on an H100
    (400 W limit), warm medians host vs device: 11.0 vs 7.3 ms at
    100k x 100k, 29.4 vs 33.0 ms at 500k x 500k, 457 vs 574 ms at
    2.35M x 7.68M — and the device's first query per shape compiles for
    13-76 s.  Its only edge is 3.7 ms warm at 200k total rows, so nearest
    routes host unless SEQUILA_HOST_THRESHOLD=0 forces the device path
    (the kernel-test override).

    Those constants assume the threaded C++ index; without it
    (SEQUILA_NATIVE=0) the NumPy fallback's no-overlap finisher is a
    per-probe Python loop, so only small inputs stay host (the pair
    cost model's host constants would mis-route — they model the
    threaded native searches, not a Python loop)."""
    from sequila_tpu.native.loader import available

    if _host_threshold() == 0:
        return False
    if not available():
        return n + m <= _host_threshold()
    return True


# Host<->device link profile: round trip (s) and copy bandwidth (B/s) of
# one H100 80GB HBM3 (700 W) behind PCIe, timed with block_until_ready
# over 4-64 MB pageable host buffers.  Every host-vs-device router reads
# it through link_profile(); SEQUILA_LINK_RTT / SEQUILA_LINK_BW override.
LINK_RTT_S = 6.5e-4
LINK_BW_BPS = 4.2e9


def link_profile() -> tuple[float, float]:
    """(round trip seconds, bandwidth bytes/s) of the host<->device link."""
    return (
        float(_os.environ.get("SEQUILA_LINK_RTT", LINK_RTT_S)),
        float(_os.environ.get("SEQUILA_LINK_BW", LINK_BW_BPS)),
    )


def materialize_route_host(n: int, m: int) -> bool:
    """Host-vs-device routing for MATERIALIZING interval work (cost model).

    Counting queries return scalars, so the device link cost is O(1) and
    the device wins at scale — the small-input `_host_threshold` is the
    right rule there.  A materializing query's pair indices (or per-probe
    payloads) must cross the link no matter what (output assembly is
    host-side arrow take), so the device's advantage shrinks to the
    bounds computation while it pays ~4 bytes/probe (counts fetch) plus
    ~8 bytes/run (compact runs) over the link.  Compare the costs each
    path does NOT share:

      host   = build sort (~14 ns x n log2 n) + probe searches
               (~140 ns/probe, threaded C++)
      device = 2 RTT + (4 x m + 8 x ~2m) bytes / link bandwidth

    (emission/expansion and the take gather are common).  The host
    constants were measured on a 4-vCPU host; the link numbers come from
    ``link_profile``.  SEQUILA_HOST_THRESHOLD=0 keeps forcing the device
    path (test override), and inputs under the threshold keep the
    unconditional host route."""
    thr = _host_threshold()
    if thr == 0:
        return False
    if n + m <= thr:
        return True
    import math

    rtt, bw = link_profile()
    host_cost = 14e-9 * n * math.log2(max(n, 2)) + 140e-9 * m
    device_cost = 2 * rtt + (4.0 * m + 8.0 * 2 * m) / bw
    return host_cost <= device_cost


# Algorithm -> rank strategy of ops/interval_join.overlap_bounds.
_ALG_METHOD = {
    Algorithm.COITREES: "sort",
    Algorithm.SUPER_INTERVALS: "sort",
    Algorithm.LAPPER: "window",
    Algorithm.INTERVAL_TREE: "bsearch",
    Algorithm.ARRAY_INTERVAL_TREE: "bsearch",
    Algorithm.COITREES_NEAREST: "sort",
    Algorithm.COITREES_COUNT_OVERLAPS: "sort",
}


def _eval_keys(exprs: list[PhysicalExpr], table: Table) -> list:
    """Key columns for dictionary encoding; plain Column exprs pass the
    arrow column through untouched (no python-string materialization)."""
    from sequila_tpu.planner.expr import Column

    out = []
    cols = None
    for e in exprs:
        if isinstance(e, Column):
            out.append(table.column(e.index))
        else:
            if cols is None:
                cols = [table.column_np(i) for i in range(len(table.column_names))]
            out.append(np.asarray(e.eval(cols, table.num_rows)))
    return out


def _eval_as_i32(expr: PhysicalExpr, table: Table) -> np.ndarray:
    """Evaluate an interval-bound expression and cast to i32, hard-erroring
    on overflow — the reference's evaluate_as_i32 contract
    (interval_join.rs:1661-1672)."""
    from sequila_tpu.errors import CastOverflowError, ExecutionError
    from sequila_tpu.models.table import I32_MAX, I32_MIN
    from sequila_tpu.planner.expr import Column

    if isinstance(expr, Column):
        # routes through the NULL check + overflow contract in one place
        return table.column_as_i32(expr.index)
    cols = [table.column_np(i) for i in range(len(table.column_names))]
    arr = np.asarray(expr.eval(cols, table.num_rows))
    if arr.dtype == np.int32:
        return arr
    if not (
        np.issubdtype(arr.dtype, np.integer) or np.issubdtype(arr.dtype, np.floating)
    ):
        raise ExecutionError(f"interval bound column has non-numeric type {arr.dtype}")
    if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
        raise ExecutionError(
            "interval bound expression produced NULLs (bounds must be "
            "non-null; filter them out first)"
        )
    a64 = arr.astype(np.int64, copy=False)
    if len(a64) and (a64.min() < I32_MIN or a64.max() > I32_MAX):
        bad = a64[(a64 < I32_MIN) | (a64 > I32_MAX)][0]
        raise CastOverflowError(f"Can't cast value {bad} to type Int32")
    return a64.astype(np.int32)


class IntervalJoinExec(ExecPlan):
    def __init__(
        self,
        left: ExecPlan,
        right: ExecPlan,
        on: list[tuple[PhysicalExpr, PhysicalExpr]],
        filter_: JoinFilter | None,
        intervals: ColIntervals,
        join_type: str = "inner",
        algorithm: Algorithm = Algorithm.COITREES,
        low_memory: bool = False,
        mode: str = "CollectLeft",
        projection: list[int] | None = None,
        projection_names: list[str] | None = None,
        distribution: str = "auto",
    ):
        self.children = [left, right]
        self.on = on
        self.filter = filter_
        self.intervals = intervals
        self.join_type = join_type
        self.algorithm = algorithm
        self.low_memory = low_memory
        self.mode = mode
        # Partitioned-mode distribution strategy (auto|hash|shuffle|skew),
        # resolved from the session config at plan time; `auto` picks per
        # query from the key-weight histogram at execute time.
        self.distribution = distribution
        # combined-schema column indices to emit (the reference's
        # projection pushdown, interval_join.rs try_new `projection`):
        # gathers only the needed columns instead of both full tables.
        self.projection = projection
        self.projection_names = projection_names

    def schema(self):
        full = join_schema(
            self.join_type, self.children[0].schema(), self.children[1].schema()
        )
        if self.projection is None:
            return full
        names = self.projection_names or [full[i][1] for i in self.projection]
        return [(full[i][0], name) for i, name in zip(self.projection, names)]

    def _gather_views(self, left: Table, right: Table):
        """Column-pruned (zero-copy) views for output assembly, plus the
        post-gather column order.  Pruning happens BEFORE the row gather,
        so unprojected columns are never materialized."""
        if self.projection is None:
            return left, right, None
        nleft = len(left.column_names)
        lids = [i for i in self.projection if i < nleft]
        rids = [i - nleft for i in self.projection if i >= nleft]
        order = []
        li = ri = 0
        for i in self.projection:
            if i < nleft:
                order.append(li)
                li += 1
            else:
                order.append(len(lids) + ri)
                ri += 1
        return left.select(lids), right.select(rids), order

    def _assemble(self, left, right, b_rows, p_rows, left_null=None):
        """Gather one output batch through the pruned views."""
        lv, rv, order = self._gather_views(left, right)
        out = gather_join_output(lv, rv, b_rows, p_rows, left_null)
        if order is not None:
            t = out.arrow.select(order)
            if self.projection_names:
                t = t.rename_columns(self.projection_names)
            out = Table(t)
        return out

    # -- host execution -----------------------------------------------------
    def _execute_host(self, ctx, left: Table, right: Table):
        hidx, rcodes, rs, re = self._host_index(ctx, left, right)
        m = right.num_rows
        with ctx.timer(self.op_id(), "join_time"):
            if self.algorithm.is_nearest:
                rows = hidx.nearest(rcodes, rs, re)
                null_mask = rows < 0
                out = self._assemble(
                    left, right,
                    np.where(null_mask, 0, rows),
                    np.arange(m, dtype=np.int64),
                    left_null=null_mask,
                )
            elif self.join_type == "inner":
                if self.low_memory:
                    out = self._host_inner_chunked(
                        ctx, hidx, left, right, rcodes, rs, re
                    )
                else:
                    out = self._fused_host_inner(
                        hidx, left, right, rcodes, rs, re
                    )
                    if out is None:
                        b_rows, p_rows = hidx.pairs(rcodes, rs, re)
                        out = self._assemble(left, right, b_rows, p_rows)
            else:
                b_rows, p_rows = hidx.pairs(rcodes, rs, re)
                out = finish_join(
                    self.join_type, left, right,
                    b_rows.astype(np.int64), p_rows.astype(np.int64),
                )
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        ctx.metrics.add(self.op_id(), "input_rows", m)
        return out

    def _fused_host_inner(self, hidx, left: Table, right: Table,
                          rcodes, rs, re, offs=None, probe_slice=None):
        """Inner-join output assembled by the fused native emission
        (si_emit_gather): the level runs gather every build column and
        broadcast every probe column DIRECTLY into the output buffers —
        the (build_row, probe_row) index arrays and the per-column take
        never exist (the reference's emit materializes index vectors and
        take-gathers per column, interval_join.rs:1593-1632).  Returns a
        Table, or None when a column shape disqualifies (the pair + take
        path then runs).  Chunked callers pass ``offs`` (exclusive-scan
        offsets for THIS probe slice), already-sliced
        ``rcodes``/``rs``/``re``, and ``probe_slice=(lo, hi)`` so the
        probe SOURCE columns are sliced to match the chunk-local query
        indices."""
        if _os.environ.get("SEQUILA_FUSED_EMIT", "1") == "0":
            return None
        if not hasattr(hidx, "emit_gather"):
            return None  # NumPy fallback index
        lv, rv, order = self._gather_views(left, right)
        lsrc = lv.fused_take_sources()
        rsrc = rv.fused_take_sources()
        if lsrc is None or rsrc is None:
            return None
        (l_cols, l_plans), (r_cols, r_plans) = lsrc, rsrc
        if offs is None:
            _, offs = hidx.counts_offsets(rcodes, rs, re)
        total = int(offs[-1])
        # total == 0 falls through: empty buffers wrap into a schema-
        # correct empty table (returning None would make the fallback
        # re-run the whole counts pass just to emit nothing)
        b_cols, out_specs = [], []
        for ty, src in l_cols:
            out = np.empty(total, src.dtype)
            b_cols.append((src, out))
            out_specs.append((ty, out))
        q_cols = []
        for ty, src in r_cols:
            if probe_slice is not None:
                src = src[probe_slice[0] : probe_slice[1]]
            out = np.empty(total, src.dtype)
            q_cols.append((src, out))
            out_specs.append((ty, out))
        if total:
            wrote = hidx.emit_gather(rcodes, rs, re, offs, b_cols, q_cols)
            assert wrote == total, f"fused emit wrote {wrote} of {total}"
        arrays = [
            pa.Array.from_buffers(ty, total, [None, pa.py_buffer(out)])
            for ty, out in out_specs
        ]
        names = lv.column_names + rv.column_names
        t = pa.Table.from_arrays(arrays, names=names)
        plans = dict(l_plans)
        for i, d in r_plans.items():
            plans[len(l_cols) + i] = d
        if plans:
            from sequila_tpu.models.table import _rewrap_dict_columns

            t = _rewrap_dict_columns(t, plans)
        if order is not None:
            t = t.select(order)
            if self.projection_names:
                t = t.rename_columns(self.projection_names)
        return Table(t)

    def _fused_host_batches(self, hidx, left, right, rcodes, rs, re, cap):
        """Generator of assembled output Tables via the fused emission
        (capped chunks), or None when the shape disqualifies — the
        streaming twin of _fused_host_inner, sharing one counts pass for
        both chunk sizing and emission offsets."""
        if _os.environ.get("SEQUILA_FUSED_EMIT", "1") == "0":
            return None
        if not hasattr(hidx, "emit_gather"):
            return None
        lv, rv, _ = self._gather_views(left, right)
        if lv.fused_take_sources() is None or rv.fused_take_sources() is None:
            return None
        _, cum = hidx.counts_offsets(rcodes, rs, re)

        def gen():
            m = len(rcodes)
            lo = 0
            while lo < m:
                hi = max(
                    int(np.searchsorted(cum, cum[lo] + cap, side="right")) - 1,
                    lo + 1,
                )
                offs_c = cum[lo : hi + 1] - cum[lo]
                if offs_c[-1] > 0:
                    out = self._fused_host_inner(
                        hidx, left, right,
                        rcodes[lo:hi], rs[lo:hi], re[lo:hi], offs=offs_c,
                        probe_slice=(lo, hi),
                    )
                    if out is None:  # safety net; qualification was checked
                        b, p = hidx.pairs_at(
                            rcodes[lo:hi], rs[lo:hi], re[lo:hi], offs_c
                        )
                        out = self._assemble(left, right, b, p + lo)
                    yield out
                lo = hi

        return gen()

    def _timed_tables(self, ctx, gen):
        """Accrue join_time around table production only (the fused
        generator's analog of _timed_assembled)."""
        while True:
            with ctx.timer(self.op_id(), "join_time"):
                out = next(gen, None)
            if out is None:
                return
            yield out

    @staticmethod
    def _host_pair_chunks(hidx, rcodes, rs, re, cap: int):
        """Yield (probe_lo, build_rows, probe_rows_local) pair chunks from
        the host index, probe ranges sized so each chunk stays under the
        emission cap (the host twin of the device path's capped-emission
        continuation, reference interval_join.rs:1433-1579)."""
        m = len(rcodes)
        counts = hidx.counts(rcodes, rs, re)
        cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
        emit_at = getattr(hidx, "pairs_at", None)
        lo = 0
        while lo < m:
            # widest probe range whose pair total fits the cap (always
            # advance by at least one probe row)
            hi = int(np.searchsorted(cum, cum[lo] + cap, side="right")) - 1
            hi = max(hi, lo + 1)
            if emit_at is not None:
                # sizing already counted every probe: emit straight at the
                # chunk-local offsets instead of re-counting per chunk
                b_rows, p_rows = emit_at(
                    rcodes[lo:hi], rs[lo:hi], re[lo:hi],
                    cum[lo : hi + 1] - cum[lo],
                )
            else:
                b_rows, p_rows = hidx.pairs(rcodes[lo:hi], rs[lo:hi], re[lo:hi])
            if len(b_rows):
                yield lo, b_rows, p_rows
            lo = hi

    def _host_inner_chunked(self, ctx, hidx, left, right, rcodes, rs, re):
        """Low-memory host emission: concatenation of the capped chunks."""
        cap = max(4 * ctx.config.max_output_batch_size, 1)
        fused = self._fused_host_batches(hidx, left, right, rcodes, rs, re, cap)
        if fused is not None:
            parts = list(fused)
        else:
            parts = [
                self._assemble(left, right, b_rows, p_rows + lo)
                for lo, b_rows, p_rows in self._host_pair_chunks(
                    hidx, rcodes, rs, re, cap
                )
            ]
        if parts:
            return Table(pa.concat_tables([p.arrow for p in parts]))
        return self._assemble(
            left, right, np.empty(0, np.int64), np.empty(0, np.int64)
        )

    def _cached_key_codes(self, left: Table, right: Table):
        """Joint key codes from each table's cached dictionary encoding.

        Single plain-Column keys only; the per-table encodings are cached
        on the Tables, so repeated queries pay one tiny dictionary merge
        plus an O(n) remap instead of re-encoding the columns."""
        from sequila_tpu.planner.expr import Column

        if len(self.on) != 1:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if (
            left.column(l_on.index).null_count
            or right.column(r_on.index).null_count
        ):
            return None  # null keys need the sentinel-code path
        from sequila_tpu.models.table import merge_dictionaries

        def build():
            lcodes, lvals, _ = left.dict_codes(l_on.index)
            rcodes, rvals, _ = right.dict_codes(r_on.index)
            remap_l, remap_r = merge_dictionaries(lvals, rvals)
            return remap_l[lcodes], remap_r[rcodes]

        # the O(n + m) remap gathers are pair-deterministic: memoize so a
        # repeated query against a cached index skips them too
        return left.paired_memo(
            ("jointcodes", l_on.index, r_on.index, id(right)), right, build
        )

    # -- device-resident fast path -----------------------------------------
    @staticmethod
    def _device_bound(expr, table: Table):
        """Interval-bound expression over device-resident columns, or None.

        Covers plain columns and the planner's strict-op normalizations
        (`col - 1` / `col + 1`); anything else falls back to host eval."""
        from sequila_tpu.planner.expr import BinaryExpr, Column, Literal

        if isinstance(expr, Column):
            return table.device_i32(expr.index)
        if (
            isinstance(expr, BinaryExpr)
            and isinstance(expr.left, Column)
            and isinstance(expr.right, Literal)
            and expr.op in ("+", "-")
            and isinstance(expr.right.value, int)
        ):
            base = table.device_i32(expr.left.index)
            return base - expr.right.value if expr.op == "-" else base + expr.right.value
        return None

    @staticmethod
    def _bound_col_delta(expr, table: Table):
        """(column index, ±int delta) for a bound expr, or None."""
        from sequila_tpu.planner.expr import BinaryExpr, Column, Literal

        if isinstance(expr, Column):
            return expr.index, 0
        if (
            isinstance(expr, BinaryExpr)
            and isinstance(expr.left, Column)
            and isinstance(expr.right, Literal)
            and expr.op in ("+", "-")
            and isinstance(expr.right.value, int)
        ):
            d = expr.right.value
            return expr.left.index, (-d if expr.op == "-" else d)
        return None

    def _sorted_count_inputs(self, left: Table, right: Table):
        """Shared preconditions + cached inputs for the sorted-view count
        paths (ops/merge_count.py); None when the plan shape doesn't
        qualify for BITS over cached sorted views."""
        from sequila_tpu.models.table import merge_dictionaries
        from sequila_tpu.planner.expr import Column

        if len(self.on) != 1:
            return None
        if left.num_rows == 0 or right.num_rows == 0:
            return None
        if left.num_rows >= _BITS_PARTIALS_MAX:
            return None  # rank partials would overflow int32
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if left.column(l_on.index).null_count or right.column(r_on.index).null_count:
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        qs_cd = self._bound_col_delta(self.intervals.right_interval.start, right)
        qe_cd = self._bound_col_delta(self.intervals.right_interval.end, right)
        if None in (bs_cd, be_cd, qs_cd, qe_cd):
            return None
        # degenerate probes (qs_adj > qe_adj) and inverted build intervals
        # break BITS: host min-gap checks (cached table statistics)
        if right.min_i32_diff(qe_cd[0], qs_cd[0]) + qe_cd[1] - qs_cd[1] < 0:
            return None
        if left.min_i32_diff(be_cd[0], bs_cd[0]) + be_cd[1] - bs_cd[1] < 0:
            return None

        lcodes, lvals, _ = left.dict_codes(l_on.index)
        rcodes, rvals, _ = right.dict_codes(r_on.index)
        if len(lvals) and len(rvals) and type(lvals[0]) is not type(rvals[0]):
            # merge_dictionaries would str-coerce, breaking the monotone
            # remap the cached sorted views depend on -> co-sort path
            return None
        remap_b, remap_q = merge_dictionaries(lvals, rvals)
        return l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd, remap_b, remap_q

    def _merge_sorted_count(self, ctx, left: Table, right: Table):
        """Packed-u32 merge count over cached sorted views — the
        whole-genome count(*) fast path (no device sort at all; see
        ops/merge_count.py).  None when the plan shape, the key
        dtypes, or the 32-bit span budget disqualify it."""
        from sequila_tpu.ops import merge_count as mc

        inputs = self._sorted_count_inputs(left, right)
        if inputs is None:
            return None
        l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd, remap_b, remap_q = inputs

        # device C tables are deterministic per (table pair, bound
        # columns, deltas): bounded paired memo on the table
        plan = left.paired_memo(
            ("mcount", l_on.index, r_on.index, bs_cd, be_cd, qs_cd, qe_cd,
             id(right)),
            right,
            lambda: self._merge_count_plan(
                left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
                remap_b, remap_q,
            ),
        )
        if plan is None:
            return None
        with ctx.timer(self.op_id(), "join_time"):
            total = mc.partials_to_total(mc.merge_count_passes(*plan))
        ctx.metrics.add(self.op_id(), "output_rows", total)
        return total

    def _merge_count_plan(
        self, left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
        remap_b, remap_q,
    ):
        """Device argument tuple for merge_count_passes, or None if the
        packing is infeasible (span > 32 bits, probe too large)."""
        from sequila_tpu.ops import merge_count as mc

        views = (
            left.per_key_minmax(l_on.index, bs_cd[0]),
            left.per_key_minmax(l_on.index, be_cd[0]),
            right.per_key_minmax(r_on.index, qs_cd[0]),
            right.per_key_minmax(r_on.index, qe_cd[0]),
        )
        deltas = (bs_cd[1], be_cd[1], qs_cd[1], qe_cd[1])
        ctabs = mc.plan_packing(remap_b, remap_q, views, deltas)
        if ctabs is None:
            return None
        c_be, c_qs, c_bs, c_qe = ctabs
        # cached sorted views: pass 1 ranks build(k,end) in probe(k,qs);
        # pass 2 ranks build(k,start) in probe(k,qe)
        bl_k, bl_v, _, _, _ = left.sorted_interval_view(l_on.index, be_cd[0])
        pq_k, pq_v, _, _, _ = right.sorted_interval_view(r_on.index, qs_cd[0])
        bu_k, bu_v, _, _, _ = left.sorted_interval_view(l_on.index, bs_cd[0])
        pe_k, pe_v, _, _, _ = right.sorted_interval_view(r_on.index, qe_cd[0])
        if pq_k.shape[0] >= mc._M_LIMIT:
            return None  # rank partials would overflow int32
        return (
            bl_k, bl_v, jnp.asarray(c_be),
            pq_k, pq_v, jnp.asarray(c_qs),
            bu_k, bu_v, jnp.asarray(c_bs),
            pe_k, pe_v, jnp.asarray(c_qe),
        )

    def _merge_probe_counts(self, ctx, left: Table, right: Table):
        """Per-probe CountOverlaps via the packed-u32 merge backend
        (ops/merge_count.merge_probe_count_passes): ranks the cached
        sorted PROBE views inside the cached sorted BUILD views — the
        mirror of _merge_sorted_count, reusing the same four packings —
        then scatters the two rank passes back to probe row order on
        device.  No device sort at all.  None when the plan shape or the
        32-bit span budget disqualifies packing."""
        from sequila_tpu.ops import merge_count as mc

        inputs = self._sorted_count_inputs(left, right)
        if inputs is None:
            return None
        l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd, remap_b, remap_q = inputs

        plan = left.paired_memo(
            ("mpcount", l_on.index, r_on.index, bs_cd, be_cd, qs_cd, qe_cd,
             id(right)),
            right,
            lambda: self._merge_probe_plan(
                left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
                remap_b, remap_q,
            ),
        )
        if plan is None:
            return None
        with ctx.timer(self.op_id(), "join_time"):
            counts = np.asarray(mc.merge_probe_count_passes(*plan))
        return counts[: right.num_rows]

    def _merge_probe_plan(
        self, left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
        remap_b, remap_q,
    ):
        """Device argument tuple for merge_probe_count_passes, or None if
        the packing is infeasible (span > 32 bits)."""
        from sequila_tpu.ops import merge_count as mc

        views = (
            left.per_key_minmax(l_on.index, bs_cd[0]),
            left.per_key_minmax(l_on.index, be_cd[0]),
            right.per_key_minmax(r_on.index, qs_cd[0]),
            right.per_key_minmax(r_on.index, qe_cd[0]),
        )
        deltas = (bs_cd[1], be_cd[1], qs_cd[1], qe_cd[1])
        ctabs = mc.plan_packing(remap_b, remap_q, views, deltas)
        if ctabs is None:
            return None
        c_be, c_qs, c_bs, c_qe = ctabs
        # pass A ranks probe(k,qe) in build(k,start); pass B ranks
        # probe(k,qs) in build(k,end) — queries are the PROBE views here
        pe_k, pe_v, _, _, _ = right.sorted_interval_view(r_on.index, qe_cd[0])
        bs_k, bs_v, _, _, _ = left.sorted_interval_view(l_on.index, bs_cd[0])
        pq_k, pq_v, _, _, _ = right.sorted_interval_view(r_on.index, qs_cd[0])
        be_k, be_v, _, _, _ = left.sorted_interval_view(l_on.index, be_cd[0])
        cap = int(pe_k.shape[0])

        def pad_order(order):
            out = np.full(cap, cap, np.int32)  # PAD slots scatter-drop
            out[: len(order)] = order
            return out

        ord_qe = pad_order(right.sorted_interval_order(r_on.index, qe_cd[0]))
        ord_qs = pad_order(right.sorted_interval_order(r_on.index, qs_cd[0]))
        return (
            pe_k, pe_v, jnp.asarray(c_qe),
            bs_k, bs_v, jnp.asarray(c_bs),
            pq_k, pq_v, jnp.asarray(c_qs),
            be_k, be_v, jnp.asarray(c_be),
            jnp.asarray(ord_qe), jnp.asarray(ord_qs),
        )

    def _merge_bounds_plan(self, left: Table, right: Table, index):
        """Sort-free merge-rank plan for EMISSION bounds
        (ops/merge_count.plan_level_bounds), or None.

        Preconditions are the count path's minus the degenerate-probe /
        inverted-build data checks: the level-run identity is exact for
        every query and row shape, so this route is wider than BITS.
        SEQUILA_EMIT_BACKEND=cosort forces the co-sort bounds."""
        from sequila_tpu.models.table import merge_dictionaries
        from sequila_tpu.ops import merge_count as mc
        from sequila_tpu.planner.expr import Column

        if _os.environ.get("SEQUILA_EMIT_BACKEND", "merge") != "merge":
            return None
        if len(self.on) != 1 or left.num_rows == 0 or right.num_rows == 0:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if left.column(l_on.index).null_count or right.column(r_on.index).null_count:
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        qs_cd = self._bound_col_delta(self.intervals.right_interval.start, right)
        qe_cd = self._bound_col_delta(self.intervals.right_interval.end, right)
        if None in (bs_cd, be_cd, qs_cd, qe_cd):
            return None
        _, lvals, _ = left.dict_codes(l_on.index)
        _, rvals, _ = right.dict_codes(r_on.index)
        if len(lvals) and len(rvals) and type(lvals[0]) is not type(rvals[0]):
            return None  # str-coercing merge would break monotone remaps
        # plan memo (mirror of the count path's 'mcount' memo): the plan
        # holds per-level slices and C tables.  valid() pins the index
        # identity so a cache miss in _prepare invalidates the plan too.
        def build():
            remap_b, remap_q = merge_dictionaries(lvals, rvals)
            views = (
                left.per_key_minmax(l_on.index, bs_cd[0]),
                left.per_key_minmax(l_on.index, be_cd[0]),
                right.per_key_minmax(r_on.index, qs_cd[0]),
                right.per_key_minmax(r_on.index, qe_cd[0]),
            )
            return index, mc.plan_level_bounds(
                index, right, r_on.index, qs_cd, qe_cd, bs_cd, be_cd,
                remap_b, remap_q, views,
            )

        _, plan = left.paired_memo(
            ("mbplan", l_on.index, r_on.index, bs_cd, be_cd, qs_cd, qe_cd,
             id(right)),
            right,
            build,
            valid=lambda v: v[0] is index,
        )
        return plan

    def _merge_pair_chunks(self, index, plan, cap: int | None):
        """Yield (probe_lo, build_rows, probe_rows_local) pair chunks from
        the merge-rank bounds — the sort-free twin of _device_pair_chunks.

        Bounds for the WHOLE probe are computed once (2L rank passes,
        no device sort); ``cap`` then slices them into emission chunks by
        the exact per-probe counts — the RANKS are never recomputed (the
        co-sort path re-sorts per chunk), though each chunk still pays
        one counts fetch inside materialize_pairs_from_bounds for its
        nnz/maxrun compaction decision."""
        from sequila_tpu.ops.interval_join import (
            _counts_and_nnz,
            materialize_pairs_from_bounds,
        )
        from sequila_tpu.ops import merge_count as mc

        lb, ub = mc.merge_level_bounds(plan)
        if cap is None:
            b, p, total = materialize_pairs_from_bounds(index, lb, ub)
            if total:
                yield 0, b, p
            return
        packed = np.asarray(_counts_and_nnz(lb, ub))
        counts = packed[:-2]
        cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
        m = len(counts)
        L = lb.shape[0]
        lo = 0
        while lo < m:
            # widest probe range whose pair total fits the cap (always
            # advance by at least one probe row); all-zero stretches of
            # `cum` advance in one step
            hi = max(
                int(np.searchsorted(cum, cum[lo] + cap, side="right")) - 1,
                lo + 1,
            )
            if cum[hi] > cum[lo]:
                rows = hi - lo
                cap_rows = _bucket(rows, minimum=1024)
                pad = ((0, 0), (0, cap_rows - rows))
                lb_c = jnp.pad(jax.lax.slice(lb, (0, lo), (L, hi)), pad)
                ub_c = jnp.pad(jax.lax.slice(ub, (0, lo), (L, hi)), pad)
                b, p, total = materialize_pairs_from_bounds(index, lb_c, ub_c)
                if total:
                    yield lo, b, p
            lo = hi

    def _device_resident_count(self, ctx, left: Table, right: Table):
        """One-device-program count over cached resident columns, or None
        if the plan shape doesn't qualify (multi-key, complex exprs,
        nullable keys) or degenerate probe rows require the exact path."""
        from sequila_tpu.ops.interval_join import counts_bits_fused
        from sequila_tpu.planner.expr import Column, Literal

        if len(self.on) != 1:
            return None
        l_on, r_on = self.on[0]
        synthetic = isinstance(l_on, Literal) and isinstance(r_on, Literal)
        if not synthetic and not (
            isinstance(l_on, Column) and isinstance(r_on, Column)
        ):
            return None
        if left.num_rows >= _BITS_PARTIALS_MAX:
            # 64-row bucket partials could overflow int32 for very large
            # build sides; use the exact chunked path instead
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        if bs_cd is not None and be_cd is not None:
            if left.min_i32_diff(be_cd[0], bs_cd[0]) + be_cd[1] - bs_cd[1] < 0:
                return None  # inverted build intervals break BITS
        ls = self._device_bound(self.intervals.left_interval.start, left)
        le = self._device_bound(self.intervals.left_interval.end, left)
        rs = self._device_bound(self.intervals.right_interval.start, right)
        re = self._device_bound(self.intervals.right_interval.end, right)
        if any(x is None for x in (ls, le, rs, re)):
            return None

        if synthetic:
            lk = jnp.zeros((left.num_rows,), jnp.int32)
            rk = jnp.zeros((right.num_rows,), jnp.int32)
            remap_l = jnp.zeros((1,), jnp.int32)
            remap_r = jnp.zeros((1,), jnp.int32)
        else:
            lcol = left.column(l_on.index)
            rcol = right.column(r_on.index)
            if lcol.null_count or rcol.null_count:
                return None
            from sequila_tpu.models.table import device_remaps

            _, _, lk = left.dict_codes(l_on.index)
            _, _, rk = right.dict_codes(r_on.index)
            remap_l, remap_r = device_remaps(left, l_on.index, right, r_on.index)

        n_pad = _bucket(max(left.num_rows, 1), minimum=1024)
        m_pad = _bucket(max(right.num_rows, 1), minimum=1024)
        with ctx.timer(self.op_id(), "join_time"):
            packed = np.asarray(
                counts_bits_fused(
                    lk, ls, le, rk, rs, re, remap_l, remap_r,
                    n_pad=n_pad, m_pad=m_pad,
                )
            ).astype(np.int64)
            total, n_deg = int(packed[:-1].sum()), int(packed[-1])
            if n_deg > 0:
                return None  # exact level path required
        ctx.metrics.add(self.op_id(), "output_rows", total)
        return total

    # -- key/bound preparation ---------------------------------------------
    def _prepare(self, ctx, left: Table, right: Table, build_index: bool = True):
        on = self.on
        synthetic_keys = all(
            isinstance(l, Literal) and isinstance(r, Literal) for l, r in on
        )
        if synthetic_keys:
            # Degenerate no-equi-key join (reference NLJ rewrite path,
            # sequila_physical_planner.rs:127-148): one global key segment.
            lcodes = np.zeros(left.num_rows, np.int32)
            rcodes = np.zeros(right.num_rows, np.int32)
        else:
            codes = self._cached_key_codes(left, right)
            if codes is not None:
                lcodes, rcodes = codes
            else:
                lkeys = _eval_keys([l for l, _ in on], left)
                rkeys = _eval_keys([r for _, r in on], right)
                lcodes, rcodes, _ = encode_join_keys(lkeys, rkeys)
        ls = _eval_as_i32(self.intervals.left_interval.start, left)
        le = _eval_as_i32(self.intervals.left_interval.end, left)
        rs = _eval_as_i32(self.intervals.right_interval.start, right)
        re = _eval_as_i32(self.intervals.right_interval.end, right)
        ctx.metrics.add(self.op_id(), "build_input_rows", left.num_rows)
        # Reserve the index estimate against the memory pool before
        # materializing (the reference's try_grow + size estimate,
        # interval_join.rs:624-660): ~9 int32 arrays over padded rows.
        build_bytes = max(left.num_rows, 1) * 4 * 9
        ctx.memory.try_grow(self.op_id(), build_bytes)
        ctx.metrics.add(self.op_id(), "build_mem_used", build_bytes)
        if not build_index:
            return (lcodes, ls, le), rcodes, rs, re
        # Cache the device index per (key column, bound columns+deltas,
        # right-table identity): the joint key codes depend on BOTH
        # dictionaries, and the build (host level assignment + device
        # upload) dominates repeated materializing queries.  Plain-Column
        # shapes only — complex exprs rebuild each time.
        cache_key = self._index_cache_key(left, right)
        if cache_key is not None:
            def build():
                with ctx.timer(self.op_id(), "build_time"):
                    return build_interval_index(lcodes, ls, le)

            return left.paired_memo(cache_key, right, build), rcodes, rs, re
        with ctx.timer(self.op_id(), "build_time"):
            index = build_interval_index(lcodes, ls, le)
        return index, rcodes, rs, re

    def _index_cache_key(self, left: Table, right: Table):
        """Cache key for the device IntervalIndex, or None when the plan
        shape (multi-key, complex exprs, nullable keys) precludes it."""
        from sequila_tpu.planner.expr import Column

        if len(self.on) != 1:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if left.column(l_on.index).null_count or right.column(r_on.index).null_count:
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        if bs_cd is None or be_cd is None:
            return None
        return ("devindex", l_on.index, r_on.index, bs_cd, be_cd, id(right))

    @staticmethod
    def _pad_chunk(rcodes, rs, re, lo, rows):
        # Padding probes get a degenerate interval (qe < qs) so their match
        # count is identically zero — in particular they cannot match the
        # index's own padding rows, which share PAD_KEY.
        cap = _bucket(rows, minimum=1024)
        k = np.full(cap, PAD_KEY, np.int32)
        s = np.full(cap, PAD_VAL, np.int32)
        e = np.full(cap, PAD_VAL - 2, np.int32)
        k[:rows] = rcodes[lo : lo + rows]
        s[:rows] = rs[lo : lo + rows]
        e[:rows] = re[lo : lo + rows]
        return jnp.asarray(k), jnp.asarray(s), jnp.asarray(e), cap

    @staticmethod
    def _chunk_count_method(rs, re, lo, rows, fallback_method, build_inverted=False):
        """BITS for clean chunks; degenerate (qs > qe) probe rows AND
        inverted build intervals (end < start) break the BITS subset
        argument and must go through the exact level/window path
        (CLAUDE.md invariant)."""
        if build_inverted:
            return fallback_method
        if bool((rs[lo : lo + rows] > re[lo : lo + rows]).any()):
            return fallback_method
        return "bits"

    def _use_host(self, left: Table, right: Table) -> bool:
        return left.num_rows + right.num_rows <= _host_threshold()

    def _route_materialize_host(self, left: Table, right: Table) -> bool:
        """Host-vs-device routing for MATERIALIZING joins — see
        materialize_route_host."""
        return materialize_route_host(left.num_rows, right.num_rows)

    def _partitioned_mesh(self, ctx):
        """The execution mesh when this node was planned in Partitioned
        mode (reference PartitionMode::Partitioned + required
        HashPartitioned distribution, interval_join.rs:385-404); None for
        CollectLeft/single-chip execution."""
        if self.mode != "Partitioned":
            return None
        from sequila_tpu.parallel.engine import get_engine_mesh

        return get_engine_mesh(ctx.config.target_partitions)

    # -- partitioned (mesh) execution ---------------------------------------
    @staticmethod
    def _data_flags(lcodes, ls, le, rcodes, rs, re):
        """(codes_nonneg, probes_nondegenerate, builds_noninverted) — the
        preconditions of the skew rank arithmetic (all three) and the
        shuffle BITS count (the last two); see CLAUDE.md invariants."""
        nonneg = not bool((lcodes < 0).any()) and not bool((rcodes < 0).any())
        nondeg = not bool((rs > re).any())
        noninv = not bool((le < ls).any())
        return nonneg, nondeg, noninv

    def _choose_distribution(
        self, mesh, lcodes, ls, le, rcodes, rs, re, op: str
    ) -> str:
        """Resolve the Partitioned-mode distribution for this execution.

        The reference's Partitioned mode hash-distributes both sides
        (interval_join.rs:385-404); here `auto` routes each query to the
        engine's best distribution: skew-aware range splitting when one
        key dominates the weight histogram (the plan_partitions criterion,
        parallel/skew.py:54-109), the device all_to_all shuffle otherwise,
        and host hash partitioning for shapes the collective kernels'
        preconditions exclude.  `op` is 'pairs', 'count' or 'nearest':
        the shuffle COUNT kernel is BITS-based and needs non-degenerate
        probes and non-inverted builds, the shuffle PAIRS emission is the
        max-extension window — exact for every shape — and NEAREST has no
        shuffle kernel (it routes skew when hot, hash otherwise; the skew
        boundary-fringe replication is exact under the engine's canonical
        tie-breaking, parallel/skew.py:skew_partitioned_nearest)."""
        nonneg, nondeg, noninv = self._data_flags(lcodes, ls, le, rcodes, rs, re)
        skew_ok = nonneg and nondeg and noninv
        shuffle_ok = (
            (nondeg and noninv) if op == "count" else op != "nearest"
        )
        cfg = self.distribution
        if cfg == "skew":
            return "skew" if skew_ok else "hash"
        if cfg == "shuffle":
            return "shuffle" if shuffle_ok else "hash"
        if cfg == "hash":
            return "hash"
        # auto
        npart = mesh.shape["part"]
        if npart <= 1:
            # degenerate 1-partition mesh: the collective exchange buys
            # nothing (measured 4.6x slower than host partitioning on a
            # single chip) — host hash partitioning is CollectLeft-shaped
            return "hash"
        if nonneg and len(lcodes) and len(rcodes):
            num = int(max(lcodes.max(), rcodes.max())) + 1
            wb = np.bincount(lcodes, minlength=num).astype(np.int64)
            wp = np.bincount(rcodes, minlength=num).astype(np.int64)
            w = wb + wp
            hot = int(np.argmax(w))
            skewed = (
                w[hot] > 1.5 * int(w.sum()) / npart
                and wp[hot] > npart
            )
            if skewed and skew_ok:
                return "skew"
        return "shuffle" if shuffle_ok else "hash"

    def _execute_partitioned(self, ctx, mesh, left: Table, right: Table):
        """SPMD execution over the device mesh, distribution-routed:
        hash-partitioned build + 2-D sharded probe, the device-side
        all_to_all shuffle, or skew-aware range splitting (the
        engine-native Partitioned mode, reference
        interval_join.rs:459-510)."""
        from sequila_tpu.parallel.partitioned_join import partitioned_nearest

        (lcodes, ls, le), rcodes, rs, re = self._prepare(
            ctx, left, right, build_index=False
        )
        m = right.num_rows
        with ctx.timer(self.op_id(), "join_time"):
            if self.algorithm.is_nearest:
                from sequila_tpu.parallel.skew import skew_partitioned_nearest

                dist = self._choose_distribution(
                    mesh, lcodes, ls, le, rcodes, rs, re, "nearest"
                )
                ctx.metrics.add(self.op_id(), f"distribution_{dist}")
                if dist == "skew":
                    # hot contigs range-split; boundary fringe replication
                    # keeps the canonical pick exact (parallel/skew.py)
                    rows = skew_partitioned_nearest(
                        mesh, lcodes, ls, le, rcodes, rs, re
                    )
                else:
                    rows = partitioned_nearest(
                        mesh, lcodes, ls, le, rcodes, rs, re
                    )
                null_mask = rows < 0
                out = self._assemble(
                    left, right,
                    np.where(null_mask, 0, rows),
                    np.arange(m, dtype=np.int64),
                    left_null=null_mask,
                )
            else:
                b, p = self._partitioned_pairs_ordered(
                    ctx, mesh, lcodes, ls, le, rcodes, rs, re,
                    empty=left.num_rows == 0 or right.num_rows == 0,
                )
                if self.join_type == "inner":
                    out = self._assemble(left, right, b, p)
                else:
                    out = finish_join(self.join_type, left, right, b, p)
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        ctx.metrics.add(self.op_id(), "input_rows", m)
        return out

    def _partitioned_pairs_ordered(
        self, ctx, mesh, lcodes, ls, le, rcodes, rs, re, empty: bool
    ):
        """Distribution-routed pair materialization over the mesh, with
        probe-side order restored — (build_rows, probe_rows) int64."""
        from sequila_tpu.parallel.engine import get_flat_mesh
        from sequila_tpu.parallel.partitioned_join import partitioned_pairs
        from sequila_tpu.parallel.shuffle import all_to_all_partitioned_pairs
        from sequila_tpu.parallel.skew import skew_partitioned_pairs

        # low-memory mode drains shards through a capped buffer
        # (chunked continuation) instead of one max-shard buffer
        chunk_limit = (
            4 * ctx.config.max_output_batch_size if self.low_memory else None
        )
        if empty:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        dist = self._choose_distribution(
            mesh, lcodes, ls, le, rcodes, rs, re, "pairs"
        )
        ctx.metrics.add(self.op_id(), f"distribution_{dist}")
        if dist == "shuffle":
            b, p = all_to_all_partitioned_pairs(
                get_flat_mesh(mesh), lcodes, ls, le, rcodes, rs, re,
                chunk_limit=chunk_limit or (1 << 22),
            )
        elif dist == "skew":
            b, p = skew_partitioned_pairs(
                mesh, lcodes, ls, le, rcodes, rs, re,
                chunk_limit=chunk_limit,
            )
        else:
            b, p = partitioned_pairs(
                mesh, lcodes, ls, le, rcodes, rs, re,
                chunk_limit=chunk_limit,
            )
        # probe-side order restored (probe order preservation contract)
        # with a STABLE probe-row-only sort: the native threaded radix
        # needs ~2 passes for row ids (24x the old full np.lexsort((b,p))
        # at 100M pairs).  Intra-probe-row match order becomes
        # shard-emission order — like the single-chip path's level-minor
        # emission, it is deterministic but not build-row-ascending (not
        # a contract: the reference compares sorted batches too).
        from sequila_tpu.exec.plan import _fast_lexsort

        order = _fast_lexsort((p,))
        return b[order].astype(np.int64), p[order].astype(np.int64)

    def _host_index(self, ctx, left: Table, right: Table):
        from sequila_tpu.ops.host_join import make_host_index

        index, rcodes, rs, re = self._prepare(
            ctx, left, right, build_index=False
        )
        # same memo discipline as the device index: the host index build
        # (native radix sort + level decomposition + hint grids) is
        # pair-deterministic and dominated small repeated queries
        # (~6 ms/query at 20k build rows before caching)
        cache_key = self._index_cache_key(left, right)
        if cache_key is not None:
            def build():
                with ctx.timer(self.op_id(), "build_time"):
                    return make_host_index(*index)

            hidx = left.paired_memo(("hostidx",) + cache_key[1:], right, build)
            return hidx, rcodes, rs, re
        with ctx.timer(self.op_id(), "build_time"):
            hidx = make_host_index(*index)
        return hidx, rcodes, rs, re

    # -- execution ----------------------------------------------------------
    def execute(self, ctx):
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)

        mesh = self._partitioned_mesh(ctx)
        if mesh is not None:
            return self._execute_partitioned(ctx, mesh, left, right)
        if self.algorithm.is_nearest:
            # nearest has its own routing (see nearest_route_host)
            if nearest_route_host(left.num_rows, right.num_rows):
                return self._execute_host(ctx, left, right)
        elif self._route_materialize_host(left, right):
            return self._execute_host(ctx, left, right)

        index, rcodes, rs, re = self._prepare(ctx, left, right)
        method = _ALG_METHOD[self.algorithm]
        m = right.num_rows

        if self.algorithm.is_nearest:
            return self._execute_nearest(ctx, left, right, index, rcodes, rs, re, method)

        chunk = (
            max(1, ctx.config.max_output_batch_size // 100)
            if self.low_memory
            else _FULL_MODE_CHUNK
        )
        out_cap = 4 * ctx.config.max_output_batch_size if self.low_memory else None
        if self.low_memory and method == "window":
            method = "sort"
        inner = self.join_type == "inner"
        parts: list[Table] = []
        all_b, all_p = [], []

        with ctx.timer(self.op_id(), "join_time"):
            gen = None
            if method == "sort":
                # sort-free merge-rank bounds (default emission backend):
                # the whole probe's [lb, ub) in 2L merge kernels over the
                # cached sorted views — no device co-sort at all
                plan = self._merge_bounds_plan(left, right, index)
                if plan is not None:
                    gen = self._merge_pair_chunks(index, plan, out_cap)
            if gen is None:
                gen = self._device_pair_chunks(
                    index, rcodes, rs, re, method, chunk, out_cap
                )
            for lo, b_rows, p_rows in gen:
                if inner:
                    # stream one output batch per probe chunk (the
                    # reference's batch-at-a-time emission); int32 row
                    # indices pass straight to arrow take
                    parts.append(
                        self._assemble(left, right, b_rows, p_rows + lo)
                    )
                else:
                    all_b.append(b_rows.astype(np.int64))
                    all_p.append(p_rows.astype(np.int64) + lo)
            if inner:
                if parts:
                    out = Table(pa.concat_tables([p.arrow for p in parts]))
                else:
                    out = self._assemble(
                        left, right, np.empty(0, np.int64), np.empty(0, np.int64)
                    )
            else:
                b = np.concatenate(all_b) if all_b else np.empty(0, np.int64)
                p = np.concatenate(all_p) if all_p else np.empty(0, np.int64)
                out = finish_join(self.join_type, left, right, b, p)
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        ctx.metrics.add(self.op_id(), "input_rows", m)
        return out

    def execute_batches(self, ctx):
        """Streaming execution for the inner join: output batches of at
        most ~4x max_output_batch_size rows, so a full-genome SELECT *
        (e.g. the 154M-row canonical join) never materializes at once —
        the engine's answer to the reference's batch-at-a-time emission
        (interval_join.rs:1338-1420).  Nearest and outer joins need the
        whole pair set (NULL-padding / global anti sets) and fall back to
        one batch."""
        if self.algorithm.is_nearest or self.join_type != "inner":
            yield self.execute(ctx)
            return
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        cap = max(4 * ctx.config.max_output_batch_size, 1)
        m = right.num_rows
        n_out = 0
        mesh = self._partitioned_mesh(ctx)
        if mesh is not None:
            # pair indices are computed whole (the global probe-order
            # restore needs them all — 16 bytes/pair), but output
            # assembly is sliced so the arrow result never materializes
            # at once
            (lcodes, ls, le), rcodes, rs, re = self._prepare(
                ctx, left, right, build_index=False
            )
            with ctx.timer(self.op_id(), "join_time"):
                b, p = self._partitioned_pairs_ordered(
                    ctx, mesh, lcodes, ls, le, rcodes, rs, re,
                    empty=left.num_rows == 0 or right.num_rows == 0,
                )
            for lo in range(0, len(b), cap):
                with ctx.timer(self.op_id(), "join_time"):
                    out = self._assemble(
                        left, right, b[lo:lo + cap], p[lo:lo + cap]
                    )
                n_out += out.num_rows
                yield out
        elif self._route_materialize_host(left, right):
            hidx, rcodes, rs, re = self._host_index(ctx, left, right)
            with ctx.timer(self.op_id(), "join_time"):
                # generator CONSTRUCTION runs the qualification + counts
                # pass — time it like the pair path times its counts
                fused = self._fused_host_batches(
                    hidx, left, right, rcodes, rs, re, cap
                )
            if fused is not None:
                for out in self._timed_tables(ctx, fused):
                    n_out += out.num_rows
                    yield out
            else:
                gen = self._host_pair_chunks(hidx, rcodes, rs, re, cap)
                for out in self._timed_assembled(ctx, left, right, gen):
                    n_out += out.num_rows
                    yield out
        else:
            index, rcodes, rs, re = self._prepare(ctx, left, right)
            method = _ALG_METHOD[self.algorithm]
            if method == "window":
                # bounded emission needs exact-count buffers (level path)
                method = "sort"
            gen = None
            if method == "sort":
                # sort-free merge-rank bounds: ranks computed ONCE for the
                # whole probe, then sliced into capped emission chunks by
                # the exact counts — no per-chunk re-counting round trips
                plan = self._merge_bounds_plan(left, right, index)
                if plan is not None:
                    gen = self._merge_pair_chunks(index, plan, cap)
            if gen is None:
                # probe chunk sized from the cardinality estimate
                # (statistics feed execution, not just EXPLAIN): chunk ~
                # cap / E[matches per probe row] hits the output cap in
                # one try — each halving iteration costs a device round
                # trip.  Estimate absent ->
                # assume ~4 matches/row; the halving loop still bounds
                # dense regions either way.
                est = self.statistics().num_rows
                if not est.is_absent and est.value and m:
                    avg = max(float(est.value) / m, 0.25)
                    chunk = int(min(max(cap / avg, 1), _FULL_MODE_CHUNK))
                else:
                    chunk = max(1, cap // 4)
                gen = self._device_pair_chunks(
                    index, rcodes, rs, re, method, chunk, cap
                )
            for out in self._timed_assembled(ctx, left, right, gen):
                n_out += out.num_rows
                yield out
        if n_out == 0:
            yield self._assemble(
                left, right, np.empty(0, np.int64), np.empty(0, np.int64)
            )
        ctx.metrics.add(self.op_id(), "output_rows", n_out)
        ctx.metrics.add(self.op_id(), "input_rows", m)

    def _timed_assembled(self, ctx, left, right, gen):
        """Assemble (lo, b, p) chunks into output Tables, accruing
        join_time around production + gather only — never the consumer
        time spent while the generator is suspended at yield."""
        while True:
            out = None
            with ctx.timer(self.op_id(), "join_time"):
                item = next(gen, None)
                if item is not None:
                    lo, b_rows, p_rows = item
                    out = self._assemble(left, right, b_rows, p_rows + lo)
            if out is None:
                return
            yield out

    def _device_pair_chunks(
        self, index, rcodes, rs, re, method: str, chunk: int, out_cap: int | None
    ):
        """Yield (probe_lo, build_rows, probe_rows_local) pair chunks from
        the device kernels, prefetched one chunk ahead.

        When ``out_cap`` bounds the EMIT buffer (low-memory / streaming
        mode), a probe chunk whose estimated pair count exceeds the cap is
        halved before materializing — the reference's capped-emission +
        batch-slice continuation (interval_join.rs:1433-1579).  The Lapper
        window emission sizes its buffer by CANDIDATES (a superset of
        matches), so bounded callers must pass a level-path ``method``,
        whose buffer is exactly the match count."""
        m = len(rcodes)
        b_inv = bool((np.asarray(index._he) < np.asarray(index._hs)).any())

        def produce(lo: int):
            """Materialize one probe chunk (device compute + link fetch +
            host expansion); runs on a prefetch thread so chunk N+1's
            device work overlaps chunk N's arrow assembly."""
            rows = min(chunk, m - lo)
            qk, qs, qe, _ = self._pad_chunk(rcodes, rs, re, lo, rows)
            if out_cap is not None:
                while rows > 1:
                    est = total_count_i64(
                        count_matches(
                            index, qk, qs, qe,
                            self._chunk_count_method(rs, re, lo, rows, method, b_inv),
                        ),
                        index.n_rows,
                    )
                    if est <= out_cap:
                        break
                    rows = max(1, rows // 2)
                    qk, qs, qe, _ = self._pad_chunk(rcodes, rs, re, lo, rows)
            b_rows, p_rows, total = materialize_pairs(index, qk, qs, qe, method)
            return lo, rows, b_rows, p_rows, total

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(produce, 0) if m > 0 else None
            while fut is not None:
                lo, rows, b_rows, p_rows, total = fut.result()
                nxt = lo + rows
                fut = ex.submit(produce, nxt) if nxt < m else None
                if total > 0:
                    yield lo, b_rows, p_rows

    def _execute_nearest(self, ctx, left, right, index, rcodes, rs, re, method):
        m = right.num_rows
        with ctx.timer(self.op_id(), "join_time"):
            outs = []
            chunk = _FULL_MODE_CHUNK
            for lo in range(0, max(m, 1), chunk):
                rows = min(chunk, m - lo)
                if rows <= 0:
                    break
                qk, qs, qe, _ = self._pad_chunk(rcodes, rs, re, lo, rows)
                res = np.asarray(nearest_match(index, qk, qs, qe, method))[:rows]
                outs.append(res)
            left_rows = (
                np.concatenate(outs) if outs else np.empty(0, np.int32)
            ).astype(np.int64)
            null_mask = left_rows < 0
            out = self._assemble(
                left, right,
                np.where(null_mask, 0, left_rows),
                np.arange(m, dtype=np.int64),
                left_null=null_mask,
            )
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def count_rows(self, ctx) -> int:
        """Exact output cardinality without materializing pairs — the
        count(*) fast path (the BITS-style count; every databio benchmark
        query is answerable by this alone)."""
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        if self.algorithm.is_nearest:
            return right.num_rows
        mesh = self._partitioned_mesh(ctx)
        if mesh is not None:
            from sequila_tpu.parallel.engine import get_flat_mesh
            from sequila_tpu.parallel.partitioned_join import partitioned_count
            from sequila_tpu.parallel.shuffle import (
                all_to_all_partitioned_count,
            )
            from sequila_tpu.parallel.skew import skew_partitioned_count_mesh

            (lcodes, ls, le), rcodes, rs, re = self._prepare(
                ctx, left, right, build_index=False
            )
            with ctx.timer(self.op_id(), "join_time"):
                if left.num_rows == 0 or right.num_rows == 0:
                    total = 0
                else:
                    dist = self._choose_distribution(
                        mesh, lcodes, ls, le, rcodes, rs, re, "count"
                    )
                    ctx.metrics.add(self.op_id(), f"distribution_{dist}")
                    if dist == "skew":
                        total = skew_partitioned_count_mesh(
                            mesh, lcodes, ls, le, rcodes, rs, re
                        )
                    elif dist == "shuffle":
                        total = all_to_all_partitioned_count(
                            get_flat_mesh(mesh), lcodes, ls, le, rcodes, rs, re
                        )
                    else:
                        total = partitioned_count(
                            mesh, lcodes, ls, le, rcodes, rs, re
                        )
            ctx.metrics.add(self.op_id(), "output_rows", total)
            return total
        if self._use_host(left, right):
            hidx, rcodes, rs, re = self._host_index(ctx, left, right)
            total = int(hidx.counts(rcodes, rs, re).sum())
            ctx.metrics.add(self.op_id(), "output_rows", total)
            return total
        if _os.environ.get("SEQUILA_COUNT_BACKEND", "merge") == "merge":
            # default: packed-u32 rank passes over cached sorted views —
            # no device sort; falls through to the co-sort when the plan
            # shape or the 32-bit span budget disqualifies it
            # (SEQUILA_COUNT_BACKEND=cosort forces the fallback).
            total = self._merge_sorted_count(ctx, left, right)
            if total is not None:
                return total
        total = self._device_resident_count(ctx, left, right)
        if total is not None:
            return total
        index, rcodes, rs, re = self._prepare(ctx, left, right)
        method = _ALG_METHOD[self.algorithm]
        build_inverted = bool((np.asarray(index._he) < np.asarray(index._hs)).any())
        m = right.num_rows
        total = 0
        with ctx.timer(self.op_id(), "join_time"):
            for lo in range(0, max(m, 1), _FULL_MODE_CHUNK):
                rows = min(_FULL_MODE_CHUNK, m - lo)
                if rows <= 0:
                    break
                chunk_method = self._chunk_count_method(
                    rs, re, lo, rows, method, build_inverted
                )
                qk, qs, qe, _ = self._pad_chunk(rcodes, rs, re, lo, rows)
                counts = count_matches(index, qk, qs, qe, chunk_method)
                total += total_count_i64(counts, index.n_rows)
        ctx.metrics.add(self.op_id(), "output_rows", total)
        return total

    def per_probe_counts(self, ctx, with_table: bool = False):
        """CountOverlaps semantics: overlap count per probe row.

        with_table=True also returns the executed probe-side Table so
        callers (GroupedIntervalCountExec) don't re-execute the subplan."""
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        mesh = self._partitioned_mesh(ctx)
        if mesh is not None:
            from sequila_tpu.parallel.partitioned_join import (
                partitioned_probe_counts,
            )

            (lcodes, ls, le), rcodes, rs, re = self._prepare(
                ctx, left, right, build_index=False
            )
            if left.num_rows == 0 or right.num_rows == 0:
                counts = np.zeros(right.num_rows, np.int64)
            else:
                counts = partitioned_probe_counts(
                    mesh, lcodes, ls, le, rcodes, rs, re
                )
            return (counts, right) if with_table else counts
        if self._use_host(left, right):
            hidx, rcodes, rs, re = self._host_index(ctx, left, right)
            counts = hidx.counts(rcodes, rs, re).astype(np.int32)
            return (counts, right) if with_table else counts
        if _os.environ.get("SEQUILA_COUNT_BACKEND", "merge") == "merge":
            # sort-free merge backend (mirror of the count(*) fast path);
            # None -> co-sort fallback below
            counts = self._merge_probe_counts(ctx, left, right)
            if counts is not None:
                return (counts, right) if with_table else counts
        index, rcodes, rs, re = self._prepare(ctx, left, right)
        method = _ALG_METHOD[self.algorithm]
        build_inverted = bool((np.asarray(index._he) < np.asarray(index._hs)).any())
        m = right.num_rows
        outs = []
        for lo in range(0, max(m, 1), _FULL_MODE_CHUNK):
            rows = min(_FULL_MODE_CHUNK, m - lo)
            if rows <= 0:
                break
            chunk_method = self._chunk_count_method(
                rs, re, lo, rows, method, build_inverted
            )
            qk, qs, qe, _ = self._pad_chunk(rcodes, rs, re, lo, rows)
            outs.append(
                np.asarray(count_matches(index, qk, qs, qe, chunk_method))[:rows]
            )
        counts = np.concatenate(outs) if outs else np.empty(0, np.int32)
        return (counts, right) if with_table else counts

    def statistics(self):
        """Join-cardinality estimate from the children's column statistics
        (the reference's statistics() surface, interval_join.rs:586-593,
        over joins/utils.rs:136-370 estimation): equi-key containment
        estimate x interval-overlap geometric selectivity.  Nearest emits
        exactly one row per probe row, so its estimate is the probe count."""
        from sequila_tpu.exec.statistics import (
            ColumnStatistics,
            Precision,
            Statistics,
            estimate_join_statistics,
            interval_overlap_selectivity,
        )
        from sequila_tpu.planner.expr import Column

        lstat = self.children[0].statistics()
        rstat = self.children[1].statistics()
        if self.algorithm.is_nearest:
            return Statistics(rstat.num_rows.to_inexact(), Precision.absent(), ())
        on = [
            (l.index, r.index)
            for l, r in self.on
            if isinstance(l, Column) and isinstance(r, Column)
        ]

        def col(stats, expr, table_side):
            cd = self._bound_col_delta(expr, table_side)
            if cd is None or cd[0] >= len(stats.column_statistics):
                return ColumnStatistics()
            return stats.column_statistics[cd[0]]

        sel = interval_overlap_selectivity(
            col(lstat, self.intervals.left_interval.start, None),
            col(lstat, self.intervals.left_interval.end, None),
            col(rstat, self.intervals.right_interval.start, None),
            col(rstat, self.intervals.right_interval.end, None),
        )
        return estimate_join_statistics(
            self.join_type, lstat, rstat, on, selectivity=sel
        )

    def display_line(self):
        jt = JOIN_TYPE_DISPLAY[self.join_type]
        mode = self.mode
        if mode == "Partitioned":
            # the configured distribution (reference Partitioned mode's
            # required HashPartitioned distribution display analog); auto
            # resolves per query at execute time — EXPLAIN ANALYZE metrics
            # record the chosen one (distribution_<name>=1)
            mode = f"Partitioned({self.distribution})"
        s = f"IntervalJoinExec: mode={mode}, join_type={jt}, {display_on(self.on)}"
        if self.filter is not None:
            s += f", filter={self.filter.display()}"
        s += f", alg={self.algorithm}"
        if self.projection is not None:
            s += f", projection={self.projection}"
        if self.low_memory:
            s += ", low_memory=true"
        return s

    def with_children(self, children):
        return IntervalJoinExec(
            children[0], children[1], self.on, self.filter, self.intervals,
            self.join_type, self.algorithm, self.low_memory, self.mode,
            self.projection, self.projection_names, self.distribution,
        )
