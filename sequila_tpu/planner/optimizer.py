"""Physical optimizer rules.

1. IntervalJoinRule — the engine's defining rewrite, mirroring the
   reference's IntervalJoinPhysicalOptimizationRule (reference
   sequila_physical_planner.rs:24-148): walk the plan bottom-up and replace
   every HashJoinExec / NestedLoopJoinExec whose filter parses as a
   2-conjunct range-overlap predicate with an IntervalJoinExec.  Honors the
   `sequila.prefer_interval_join` off-switch; algorithm and low-memory mode
   come from the session config at optimize time.  The NLJ rewrite
   synthesizes `on = [(1, 1)]` — one global key segment — exactly like the
   reference (:127-148).

2. CountFastPathRule — engine-specific: `count(*)` over an inner interval
   join needs no pair materialization (the BITS count is exact), so
   Aggregate(count, no group-by) directly over IntervalJoinExec becomes an
   IntervalCountExec.  This is the whole databio benchmark query shape.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from sequila_tpu.config import SequilaConfig
from sequila_tpu.exec.joins.hash_join import HashJoinExec
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec
from sequila_tpu.exec.joins.nl_join import NestedLoopJoinExec
from sequila_tpu.exec.plan import AggregateExec, ExecPlan
from sequila_tpu.models.table import Table
from sequila_tpu.planner.expr import Literal
from sequila_tpu.planner.intervals import parse
from sequila_tpu.utils.logging import get_logger

log = get_logger(__name__)


class PredicatePushdownRule:
    """Push single-side filter conjuncts below joins.

    The reference gets this from DataFusion's logical optimizer; queries
    like `... JOIN ... WHERE a.contig = 'chr1'` then scan a pre-filtered
    build side.  Conjuncts referencing both sides stay above the join."""

    def optimize(self, plan: ExecPlan) -> ExecPlan:
        return plan.transform_up(self._rewrite)

    def _rewrite(self, node: ExecPlan) -> ExecPlan:
        from sequila_tpu.exec.plan import FilterExec
        from sequila_tpu.planner import expr as pe

        if not isinstance(node, FilterExec):
            return node
        join = node.children[0]
        if not isinstance(
            join, (HashJoinExec, NestedLoopJoinExec, IntervalJoinExec)
        ) or join.join_type != "inner":
            return node
        nleft = len(join.children[0].schema())

        def conjuncts(e):
            if isinstance(e, pe.BinaryExpr) and e.op == "AND":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        left_f, right_f, keep = [], [], []
        for c in conjuncts(node.predicate):
            idxs = [col.index for col in c.columns()]
            if idxs and all(i < nleft for i in idxs):
                left_f.append(c)
            elif idxs and all(i >= nleft for i in idxs):
                def rebase(n_):
                    if isinstance(n_, pe.Column):
                        return pe.Column(n_.name, n_.index - nleft)
                    return n_

                right_f.append(c.transform(rebase))
            else:
                keep.append(c)
        if not left_f and not right_f:
            return node
        new_children = list(join.children)
        for f in left_f:
            new_children[0] = FilterExec(new_children[0], f)
        for f in right_f:
            new_children[1] = FilterExec(new_children[1], f)
        new_join = join.with_children(new_children)
        if not keep:
            return new_join
        pred = keep[0]
        for c in keep[1:]:
            pred = pe.BinaryExpr(pred, "AND", c)
        return FilterExec(new_join, pred)


class IntervalJoinRule:
    def __init__(self, config: SequilaConfig):
        self.config = config

    def optimize(self, plan: ExecPlan) -> ExecPlan:
        if not self.config.prefer_interval_join:
            log.debug("prefer_interval_join=false; skipping rewrite")
            return plan
        return plan.transform_up(self._rewrite)

    def _rewrite(self, node: ExecPlan) -> ExecPlan:
        cfg = self.config
        if isinstance(node, HashJoinExec):
            intervals = parse(node.filter)
            if intervals is not None:
                log.debug("rewriting HashJoinExec -> IntervalJoinExec")
                # target_partitions > 1 selects the hash-partitioned SPMD
                # mesh execution (reference PartitionMode::Partitioned,
                # interval_join.rs:385-404); the NLJ path below stays
                # CollectLeft like the reference's from_nested_loop_join.
                mode = (
                    "Partitioned" if cfg.target_partitions > 1 else node.mode
                )
                return IntervalJoinExec(
                    node.children[0], node.children[1], node.on, node.filter,
                    intervals, node.join_type,
                    cfg.interval_join_algorithm, cfg.interval_join_low_memory,
                    mode=mode,
                    distribution=cfg.resolved_distribution(),
                )
        elif isinstance(node, NestedLoopJoinExec):
            intervals = parse(node.filter)
            if intervals is not None:
                log.debug("rewriting NestedLoopJoinExec -> IntervalJoinExec")
                on = [(Literal(1), Literal(1))]
                return IntervalJoinExec(
                    node.children[0], node.children[1], on, node.filter,
                    intervals, node.join_type,
                    cfg.interval_join_algorithm, cfg.interval_join_low_memory,
                    mode="CollectLeft",
                )
        return node


class ProjectionPushdownRule:
    """Fold a pure-column projection into the interval join.

    The reference's IntervalJoinExec carries a `projection` member
    (interval_join.rs try_new) so only the projected columns are gathered
    in the emit path; same here — the pruning happens before the row
    gather, which is the dominant host cost of wide materializations."""

    def optimize(self, plan: ExecPlan) -> ExecPlan:
        return plan.transform_up(self._rewrite)

    def _rewrite(self, node: ExecPlan) -> ExecPlan:
        from sequila_tpu.exec.plan import ProjectExec
        from sequila_tpu.planner.expr import Column

        if not isinstance(node, ProjectExec):
            return node
        join = node.children[0]
        if (
            not isinstance(join, IntervalJoinExec)
            or join.join_type != "inner"
            or join.projection is not None
            or join.algorithm.is_nearest
        ):
            return node
        if not all(isinstance(e, Column) for e in node.exprs):
            return node
        return IntervalJoinExec(
            join.children[0], join.children[1], join.on, join.filter,
            join.intervals, join.join_type, join.algorithm, join.low_memory,
            join.mode,
            projection=[e.index for e in node.exprs],
            projection_names=list(node.names),
            distribution=join.distribution,
        )


class IntervalCountExec(ExecPlan):
    """count(*) over an interval join via the count-only kernel."""

    def __init__(self, join: IntervalJoinExec, out_name: str):
        self.children = [join]
        self.out_name = out_name

    def schema(self):
        return [(None, self.out_name)]

    def execute(self, ctx):
        total = self.children[0].count_rows(ctx)
        return Table(
            pa.Table.from_arrays(
                [pa.array(np.asarray([total], np.int64))], names=[self.out_name]
            )
        )

    def display_line(self):
        return f"IntervalCountExec: aggr=[{self.out_name}]"

    def with_children(self, children):
        return IntervalCountExec(children[0], self.out_name)


class GroupedIntervalCountExec(ExecPlan):
    """count(*) GROUP BY <probe columns> over an interval join: per-probe-
    row counts (BITS) weighted-bincounted by group — never materializes
    the pairs.  The 'overlaps per chromosome' query shape."""

    def __init__(self, join: IntervalJoinExec, group_cols, group_names, out_name: str):
        self.children = [join]
        self.group_cols = group_cols  # probe-side Column exprs
        self.group_names = group_names
        self.out_name = out_name

    def schema(self):
        return [(None, n) for n in self.group_names] + [(None, self.out_name)]

    def execute(self, ctx):
        join = self.children[0]
        # with_table avoids re-executing the probe subplan (its execute
        # may be a non-trivial filter/scan pipeline)
        counts, right = join.per_probe_counts(ctx, with_table=True)
        cols = [right.column_np(c.index) for c in self.group_cols]
        from sequila_tpu.exec.plan import _row_group_codes

        codes, first_idx = _row_group_codes(cols)
        sums = np.bincount(codes, weights=counts, minlength=len(first_idx)).astype(
            np.int64
        )
        keep = sums > 0  # groups with no join rows don't exist in inner join
        arrays = [pa.array(np.asarray(c)[first_idx][keep]) for c in cols]
        arrays.append(pa.array(sums[keep]))
        return Table(
            pa.Table.from_arrays(arrays, names=list(self.group_names) + [self.out_name])
        )

    def display_line(self):
        gb = ", ".join(self.group_names)
        return f"GroupedIntervalCountExec: groupBy=[{gb}], aggr=[{self.out_name}]"

    def with_children(self, children):
        return GroupedIntervalCountExec(
            children[0], self.group_cols, self.group_names, self.out_name
        )


class CountFastPathRule:
    def optimize(self, plan: ExecPlan) -> ExecPlan:
        return plan.transform_up(self._rewrite)

    def _rewrite(self, node: ExecPlan) -> ExecPlan:
        if not (
            isinstance(node, AggregateExec)
            and len(node.agg_specs) == 1
            and isinstance(node.children[0], IntervalJoinExec)
            and node.children[0].join_type == "inner"
            and not node.children[0].algorithm.is_nearest
        ):
            return node
        func, arg, distinct, out_name, *rest = node.agg_specs[0]
        if not (
            func == "count"
            and not distinct
            and not (rest and rest[0] is not None)  # no FILTER clause
            and node.grouping_sets is None
            and (
                arg is None
                or (isinstance(arg, Literal) and arg.value is not None)
            )
        ):
            return node
        join = node.children[0]
        if not node.group_exprs:
            return IntervalCountExec(join, out_name)
        # grouped: every group expr must resolve to a probe-side column
        # (build-side join-key columns are substituted by their probe twin)
        from sequila_tpu.planner.expr import Column

        nleft = len(join.children[0].schema())
        probe_cols = []
        for g in node.group_exprs:
            if not isinstance(g, Column):
                return node
            if g.index >= nleft:
                probe_cols.append(Column(g.name, g.index - nleft))
                continue
            # build-side: allowed only if it is an equi-key column
            twin = None
            for l_on, r_on in join.on:
                if isinstance(l_on, Column) and l_on.index == g.index:
                    twin = r_on
                    break
            if twin is None or not isinstance(twin, Column):
                return node
            probe_cols.append(twin)
        return GroupedIntervalCountExec(
            join, probe_cols, node.group_names, out_name
        )
