"""sequila-tpu in five minutes: SQL and DataFrame usage side by side.

Run: python examples/demo.py  (runs on the GPU, or on the CPU with JAX_PLATFORMS=cpu)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pyarrow as pa

from sequila_tpu import SessionContext
from sequila_tpu import dataframe as gdf
from sequila_tpu.models.table import Table, pretty_format

# ---- 1. SQL: the reference engine's workflow, unchanged -------------------
ctx = SessionContext()
ctx.sql("SET sequila.prefer_interval_join TO true")
ctx.sql("SET sequila.interval_join_algorithm TO coitrees")

rng = np.random.default_rng(0)
def random_intervals(n, span=100_000, max_len=500):
    s = rng.integers(0, span, n)
    return pa.table({
        "contig": np.repeat("chr1", n),
        "pos_start": s,
        "pos_end": s + rng.integers(1, max_len, n),
    })

ctx.register_table("reads", random_intervals(5_000))
ctx.register_table("targets", random_intervals(2_000))

print(ctx.show("""
    SELECT targets.contig, count(1) AS overlaps
    FROM reads JOIN targets
      ON reads.contig = targets.contig
     AND reads.pos_end >= targets.pos_start
     AND reads.pos_start <= targets.pos_end
    GROUP BY targets.contig
"""))

print(ctx.show("""EXPLAIN
    SELECT count(1) FROM reads JOIN targets
      ON reads.contig = targets.contig
     AND reads.pos_end >= targets.pos_start
     AND reads.pos_start <= targets.pos_end"""))

# ---- 2. DataFrame API: bioframe-style operators ---------------------------
reads = ctx.table("reads")
targets = ctx.table("targets")

print(pretty_format(gdf.count_overlaps(targets, reads).slice(0, 5)))
print(pretty_format(gdf.coverage(targets, reads).slice(0, 5)))
print(pretty_format(gdf.nearest(targets.slice(0, 3), reads)))
print(pretty_format(gdf.merge(reads).slice(0, 5)))
print(pretty_format(gdf.closest(targets.slice(0, 3), reads, k=2)))

stats = gdf.jaccard(reads, targets)
print(f"jaccard(reads, targets) = {stats['jaccard']:.4f} "
      f"({stats['intersection']:,} / {stats['union']:,} bases)")

# ---- 3. Standalone IntervalMap (superintervals drop-in) -------------------
from sequila_tpu.intervalmap import IntervalMap

imap = IntervalMap()
imap.add(10, 20, "A")
imap.add(15, 40, "B")
imap.build()
print("IntervalMap.search_values(8, 16) ->", imap.search_values(8, 16))
print("IntervalMap.coverage(0, 50)      ->", imap.coverage(0, 50))
