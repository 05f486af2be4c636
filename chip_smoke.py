#!/usr/bin/env python3
"""Smoke run of the engine on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py               # one card: phases 1-4 below
    python chip_smoke.py --four-cards  # partitioned mode on four cards only

Phases (one card):
  1. fixture   — the reference's reads/targets join through SQL: count(1)
                 and SELECT * give 16, with default routing and with the
                 device forced (SEQUILA_HOST_THRESHOLD=0);
  2. genome    — the Genome-Genome pair (2,350,965 x 7,684,066 rows over
                 24 skewed contigs, the chainRn4 x chainVicPac2 row counts)
                 through SQL count(*); equals the host index exactly, and
                 the device merge-count program is the one that ran;
  3. parity    — every device operator path against the host route:
                 inner joins under four algorithms, outer joins, nearest,
                 strict operators, grouped count, the coverage and
                 count_overlaps verbs at 500k x 500k, and merge against
                 co-sort emission bounds on the 20k x 300k chr1 pair;
  4. primitive — the merge rank (ops/merge_count._rank_sorted) against
                 np.searchsorted at 7.68M x 2.35M, both directions, both
                 strictnesses, PAD sentinels present.

Every device result is int32/uint32 and no phase runs a float matrix
product, so every comparison is exact equality.  The script has no CPU
mode: without a GPU it exits non-zero before printing any result.  The
last line of its output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GENOME_N, GENOME_M = 2_350_965, 7_684_066
CHAIN_PAIRS = 14_729_736  # 20k x 300k chr1 chain pair (bench.gen_chain_table)
JOIN_ON = (
    " ON a.contig = b.contig AND a.pos_end >= b.pos_start"
    " AND a.pos_start <= b.pos_end"
)


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpus(count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r});"
            " this script has no CPU mode"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")
    return devices


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cold_warm(fn):
    """(result, cold s, warm s): the second call reuses compiled programs
    and cached table views."""
    _, cold = timed(fn)
    out, warm = timed(fn)
    return out, cold, warm


class forced_route:
    """Set SEQUILA_HOST_THRESHOLD for a block: "0" forces the device
    route, a huge value the host route, None restores the default."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("SEQUILA_HOST_THRESHOLD")
        if self.value is None:
            os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
        else:
            os.environ["SEQUILA_HOST_THRESHOLD"] = self.value
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
        else:
            os.environ["SEQUILA_HOST_THRESHOLD"] = self.old


DEVICE, HOST = "0", str(1 << 62)


def normalized(table):
    """Arrow table with positional column names, dictionary columns
    decoded and rows sorted: pair SETS compare equal regardless of the
    per-backend intra-probe match order."""
    import pyarrow as pa

    t = table.arrow if hasattr(table, "arrow") else table
    cols = []
    for col in t.columns:
        if pa.types.is_dictionary(col.type):
            col = col.cast(col.type.value_type)
        cols.append(col)
    names = [f"c{i}" for i in range(len(cols))]
    t = pa.table(dict(zip(names, cols)))
    return t.sort_by([(n, "ascending") for n in names]).combine_chunks()


def sorted_rows(int_columns) -> np.ndarray:
    """Integer result columns stacked and lexsorted (multiset compare)."""
    cols = [np.asarray(c, np.int64) for c in int_columns]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols])


def host_count(t1, t2) -> int:
    """count(*) of the overlap join from the host index (native C++ when
    it built, else NumPy) over one shared contig dictionary."""
    from sequila_tpu.ops.host_join import make_host_index

    _, codes = np.unique(
        np.concatenate([t1["contig"], t2["contig"]]), return_inverse=True
    )
    n = len(t1["contig"])
    lk, rk = codes[:n].astype(np.int32), codes[n:].astype(np.int32)
    index = make_host_index(
        lk, t1["pos_start"].astype(np.int32), t1["pos_end"].astype(np.int32)
    )
    counts = index.counts(
        rk, t2["pos_start"].astype(np.int32), t2["pos_end"].astype(np.int32)
    )
    return int(np.asarray(counts, np.int64).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_fixture() -> None:
    from sequila_tpu.session import SessionContext

    data = os.path.join(REPO, "testing", "data", "interval")
    ddl = (
        "CREATE EXTERNAL TABLE {name} (contig VARCHAR NOT NULL, "
        "pos_start BIGINT NOT NULL, pos_end BIGINT NOT NULL) STORED AS CSV "
        "LOCATION '{path}' OPTIONS ('delimiter' ',', 'has_header' 'true')"
    )

    def run():
        ctx = SessionContext()
        ctx.sql("SET sequila.prefer_interval_join TO true")
        ctx.sql(ddl.format(name="a", path=os.path.join(data, "reads.csv")))
        ctx.sql(ddl.format(name="b", path=os.path.join(data, "targets.csv")))
        count = int(ctx.sql("SELECT count(1) FROM a JOIN b" + JOIN_ON).column_np(0)[0])
        rows = ctx.sql("SELECT * FROM a JOIN b" + JOIN_ON).num_rows
        return count, rows

    for label, route in (("default", None), ("device", DEVICE)):
        with forced_route(route):
            (count, rows), cold, warm = cold_warm(run)
        if (count, rows) != (16, 16):
            raise AssertionError(f"fixture {label}: count={count} rows={rows}, want 16")
        log(f"phase fixture[{label}]: count(1)={count} SELECT*={rows} "
            f"cold {cold:.3f}s warm {warm:.3f}s")


def phase_genome(n: int = GENOME_N, m: int = GENOME_M) -> None:
    import pyarrow as pa

    import bench
    from sequila_tpu.ops import interval_join as oij
    from sequila_tpu.ops import merge_count as mc
    from sequila_tpu.session import SessionContext

    (t1, t2), gen = timed(
        lambda: (bench.gen_genome_table(n, 21), bench.gen_genome_table(m, 22))
    )
    ctx = SessionContext()
    ctx.register_table("s1", pa.table(t1))
    ctx.register_table("s2", pa.table(t2))
    ctx.sql("SET sequila.prefer_interval_join = true")
    mc.merge_count_passes.clear_cache()
    oij.counts_bits_fused.clear_cache()
    query = "SELECT count(1) FROM s1 a JOIN s2 b" + JOIN_ON
    with forced_route(None):
        got, cold, warm = cold_warm(lambda: int(ctx.sql(query).column_np(0)[0]))
    want, host_s = timed(lambda: host_count(t1, t2))
    if got != want:
        raise AssertionError(f"genome count {got} != host index {want}")
    merge_programs = mc.merge_count_passes._cache_size()
    cosort_programs = oij.counts_bits_fused._cache_size()
    if merge_programs == 0 or cosort_programs != 0:
        raise AssertionError(
            f"device merge route did not run (merge programs {merge_programs}, "
            f"co-sort programs {cosort_programs})"
        )
    log(f"phase genome: {n} x {m} count={got} == host index {want}; "
        f"merge_count_passes programs={merge_programs}, co-sort programs=0; "
        f"cold {cold:.3f}s warm {warm:.3f}s (data {gen:.1f}s, host index {host_s:.2f}s)")


def phase_parity(n_sql: int = 200_000, m_sql: int = 300_000,
                 n_verb: int = 500_000, chain=(20_000, 300_000),
                 chain_pairs: int | None = CHAIN_PAIRS) -> None:
    import pyarrow as pa

    import bench
    from sequila_tpu import dataframe as gdf
    from sequila_tpu.models.table import Table
    from sequila_tpu.session import SessionContext

    t0 = time.perf_counter()
    ctx = SessionContext()
    ctx.register_table("a", pa.table(bench.gen_genome_table(n_sql, 31)))
    ctx.register_table("b", pa.table(bench.gen_genome_table(m_sql, 32)))
    ctx.sql("SET sequila.prefer_interval_join = true")
    inner = "SELECT * FROM a JOIN b" + JOIN_ON
    checks = [
        ("inner", inner, ("coitrees", "intervaltree", "lapper", "superintervals")),
        ("left outer", inner.replace(" JOIN ", " LEFT JOIN "), ("coitrees",)),
        ("full outer", inner.replace(" JOIN ", " FULL JOIN "), ("coitrees",)),
        ("nearest", inner, ("coitreesnearest",)),
        ("strict", inner.replace("<=", "<").replace(">=", ">"), ("coitrees",)),
        ("grouped count",
         "SELECT a.contig, count(1) AS n FROM a JOIN b" + JOIN_ON
         + " GROUP BY a.contig ORDER BY a.contig", ("coitrees",)),
    ]
    cold = warm = 0.0
    for name, query, algorithms in checks:
        for alg in algorithms:
            ctx.sql(f"SET sequila.interval_join_algorithm = {alg}")
            with forced_route(DEVICE):
                dev, c, w = cold_warm(lambda: ctx.sql(query))
            cold, warm = cold + c, warm + w
            with forced_route(HOST):
                host = ctx.sql(query)
            if not normalized(dev).equals(normalized(host)):
                raise AssertionError(f"parity {name}/{alg}: device != host")
            log(f"  parity {name}[{alg}]: {dev.num_rows} rows OK "
                f"(device cold {c:.3f}s warm {w:.3f}s)")

    A = Table(pa.table(bench.gen_genome_table(n_verb, 33)))
    B = Table(pa.table(bench.gen_genome_table(n_verb, 34)))
    for verb in (gdf.coverage, gdf.count_overlaps):
        with forced_route(DEVICE):
            dev, c, w = cold_warm(lambda: verb(A, B))
        cold, warm = cold + c, warm + w
        with forced_route(HOST):
            host = verb(A, B)
        if not normalized(dev).equals(normalized(host)):
            raise AssertionError(f"parity {verb.__name__}: device != host")
        log(f"  parity {verb.__name__} {n_verb}x{n_verb}: {dev.num_rows} rows OK "
            f"(device cold {c:.3f}s warm {w:.3f}s)")

    cctx = SessionContext()
    cctx.register_table("a", pa.table(bench.gen_chain_table(chain[0], 13)))
    cctx.register_table("b", pa.table(bench.gen_chain_table(chain[1], 14)))
    cctx.sql("SET sequila.prefer_interval_join = true")
    pairs_q = "SELECT a.pos_start, a.pos_end, b.pos_start, b.pos_end FROM a JOIN b" + JOIN_ON
    results = {}
    for backend in ("merge", "cosort"):
        os.environ["SEQUILA_EMIT_BACKEND"] = backend
        try:
            with forced_route(DEVICE):
                out, c, w = cold_warm(lambda: cctx.sql(pairs_q))
        finally:
            os.environ.pop("SEQUILA_EMIT_BACKEND", None)
        cold, warm = cold + c, warm + w
        results[backend] = sorted_rows(out.column_np(i) for i in range(4))
        log(f"  emission bounds[{backend}]: {out.num_rows} pairs "
            f"(device cold {c:.3f}s warm {w:.3f}s)")
    n_pairs = results["merge"].shape[1]
    if chain_pairs is not None and n_pairs != chain_pairs:
        raise AssertionError(f"chain pairs {n_pairs} != {chain_pairs}")
    if not np.array_equal(results["merge"], results["cosort"]):
        raise AssertionError("merge emission bounds != co-sort emission bounds")
    log(f"phase parity: all device paths == host; merge == co-sort on "
        f"{n_pairs} chain pairs; device cold {cold:.3f}s warm {warm:.3f}s "
        f"(phase {time.perf_counter() - t0:.1f}s)")


def phase_primitive(n: int = GENOME_N, m: int = GENOME_M) -> None:
    import jax
    import jax.numpy as jnp

    from sequila_tpu.ops import merge_count as mc

    rng = np.random.default_rng(5)

    def padded(size, sentinel):
        cap = -(-size // 2048) * 2048 + 2048  # always a PAD tail
        out = np.full(cap, sentinel, np.uint32)
        out[:size] = np.sort(rng.integers(0, 2**32 - 2, size, dtype=np.uint32))
        return out

    cold = warm = 0.0
    for n_q, n_a in ((n, m), (m, n)):
        a = padded(n_a, mc._PROBE_PAD)
        q = padded(n_q, mc._BUILD_PAD)
        a_d, q_d = jnp.asarray(a), jnp.asarray(q)
        for strict in (False, True):
            def rank():
                return jax.block_until_ready(mc._rank_sorted(a_d, q_d, strict=strict))

            got, c, w = cold_warm(rank)
            cold, warm = cold + c, warm + w
            want = np.searchsorted(a, q, side="left" if strict else "right")
            if not np.array_equal(np.asarray(got), want):
                raise AssertionError(f"rank {n_q} into {n_a} strict={strict} mismatch")
            log(f"  rank {n_q} into {n_a} strict={strict}: exact "
                f"(cold {c:.4f}s warm {w:.4f}s)")
    log(f"phase primitive: exact on both directions and strictnesses; "
        f"cold {cold:.3f}s warm {warm:.4f}s")


def phase_four_cards(n: int = GENOME_N, m: int = GENOME_M, k: int = 100_000) -> None:
    """Partitioned mode on four cards: the Genome-Genome count under each
    distribution, and partitioned pairs on the k x k skewed set (90% of
    rows on one contig, as __graft_entry__'s certification run),
    each against the single-card result and the host index."""
    import pyarrow as pa

    import bench
    from sequila_tpu.ops.host_join import make_host_index
    from sequila_tpu.session import SessionContext

    from sequila_tpu.parallel.engine import get_engine_mesh

    mesh_size = int(get_engine_mesh(4).devices.size)
    if mesh_size != 4:
        raise AssertionError(f"engine mesh spans {mesh_size} devices, want 4")

    def ran_distribution(c, q, dist):
        analyzed = c.sql("EXPLAIN ANALYZE " + q).column_np(1)[0]
        if f"distribution_{dist}=1" not in analyzed:
            raise AssertionError(f"{dist} did not run:\n{analyzed}")

    t1, t2 = bench.gen_genome_table(n, 21), bench.gen_genome_table(m, 22)
    want = host_count(t1, t2)
    ctx = SessionContext()
    ctx.register_table("s1", pa.table(t1))
    ctx.register_table("s2", pa.table(t2))
    query = "SELECT count(1) FROM s1 a JOIN s2 b" + JOIN_ON
    single, c, w = cold_warm(lambda: int(ctx.sql(query).column_np(0)[0]))
    log(f"  single card: count={single} (cold {c:.3f}s warm {w:.3f}s)")
    ctx.sql("SET datafusion.execution.target_partitions = 4")
    for dist in ("hash", "skew", "shuffle"):
        ctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        got, c, w = cold_warm(lambda: int(ctx.sql(query).column_np(0)[0]))
        ran_distribution(ctx, query, dist)
        if not got == single == want:
            raise AssertionError(f"{dist}: {got} vs single {single} vs host {want}")
        log(f"  four cards [{dist}]: count={got} == single == host "
            f"(cold {c:.3f}s warm {w:.3f}s)")

    rng = np.random.default_rng(42)
    span = 10_000_000
    lk = np.where(rng.random(k) < 0.9, 0, rng.integers(1, 24, k)).astype(np.int32)
    rk = np.where(rng.random(k) < 0.9, 0, rng.integers(1, 24, k)).astype(np.int32)
    ls = rng.integers(0, span, k).astype(np.int32)
    le = (ls + rng.integers(1, 1_500, k)).astype(np.int32)
    rs = rng.integers(0, span, k).astype(np.int32)
    re = (rs + rng.integers(1, 1_500, k)).astype(np.int32)

    def table(keys, s, e):
        return pa.table({
            "contig": np.array([f"chr{i}" for i in keys]),
            "pos_start": s.astype(np.int64),
            "pos_end": e.astype(np.int64),
        })

    hb, hp = make_host_index(lk, ls, le).pairs(rk, rs, re)
    host_rows = sorted_rows([ls[hb], le[hb], rs[hp], re[hp]])
    pctx = SessionContext()
    pctx.register_table("a", table(lk, ls, le))
    pctx.register_table("b", table(rk, rs, re))
    pairs_q = "SELECT a.pos_start, a.pos_end, b.pos_start, b.pos_end FROM a JOIN b" + JOIN_ON
    single_rows = sorted_rows(pctx.sql(pairs_q).column_np(i) for i in range(4))
    if not np.array_equal(single_rows, host_rows):
        raise AssertionError("single-card pairs != host pairs")
    pctx.sql("SET datafusion.execution.target_partitions = 4")
    for dist in ("hash", "skew", "shuffle"):
        pctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        out, c, w = cold_warm(lambda: pctx.sql(pairs_q))
        ran_distribution(pctx, pairs_q, dist)
        rows = sorted_rows(out.column_np(i) for i in range(4))
        if not np.array_equal(rows, host_rows):
            raise AssertionError(f"{dist}: partitioned pairs != host pairs")
        log(f"  four cards pairs [{dist}]: {out.num_rows} pairs == single == host "
            f"(cold {c:.3f}s warm {w:.3f}s)")
    log("phase four-cards: on a 4-device engine mesh, counts and pairs agree "
        "under hash, skew, shuffle")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the partitioned phase, on four cards")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1
    devices = require_gpus(count)

    import pyarrow

    from sequila_tpu.native.loader import available

    log("devices:", devices)
    log("card:", card_line())
    log("pyarrow:", pyarrow.__version__)
    log("native host library loaded:", available())
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_fixture()
        phase_genome()
        phase_parity()
        phase_primitive()
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
