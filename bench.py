#!/usr/bin/env python
"""databio-style interval-join benchmark (the reference's headline workload).

Canonical query (reference benches/databio_benchmark.rs:205-216):

    SELECT count(*) FROM s1 a JOIN s2 b
    ON a.contig = b.contig
    AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end

The reference's anchor numbers (BASELINE.md): chainRn4_chr1 (207,146 rows)
x chainVicPac2_chr1 (302,381 rows) -> 154,374,873 output rows in 2.457 s
with the Coitrees algorithm on one CPU core ~= 63 M output rows/s.

The databio parquet files are not present in this image (zero egress), so
the bench generates synthetic chain-alignment-like tables with the same
row counts and a length distribution tuned to reproduce the anchor's
output cardinality within a few percent; the engine's exact count is
reported alongside.  Timing covers the full SQL query execution — key
dictionary encoding, i32 bound evaluation, index build, device transfer,
BITS count kernel — per iteration, matching how criterion times the
reference's SQL path (index rebuilt every iteration).

Output: ONE JSON line
  {"metric": ..., "value": N, "unit": "output_rows_per_sec", "vs_baseline": N}
"""

import argparse
import json
import os
import sys
import time

import numpy as np

N_LEFT, N_RIGHT = 207_146, 302_381  # chainRn4_chr1 / chainVicPac2_chr1 rows
CHR1_SPAN = 245_000_000
BASELINE_ROWS_PER_SEC = 63_000_000.0  # 154.37 M rows / 2.457 s (BASELINE.md)


def gen_chain_table(n, seed, median_len=98_000, sigma=1.5):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, CHR1_SPAN, n).astype(np.int64)
    lens = np.exp(rng.normal(np.log(median_len), sigma, n)).astype(np.int64)
    ends = np.minimum(starts + np.maximum(lens, 1), 2**31 - 2)
    contig = np.full(n, "chr1")
    return {
        "contig": contig,
        "pos_start": starts.astype(np.int64),
        "pos_end": ends.astype(np.int64),
    }


QUERY = (
    "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
    "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
)


def run(algorithm="coitrees", iters=5, verbose=False, stages=False):
    import gc

    import pyarrow as pa

    from sequila_tpu.session import SessionContext

    ctx = SessionContext()
    ctx.register_table("s1", pa.table(gen_chain_table(N_LEFT, seed=1)))
    ctx.register_table("s2", pa.table(gen_chain_table(N_RIGHT, seed=2)))
    ctx.sql("SET sequila.prefer_interval_join = true")
    ctx.sql(f"SET sequila.interval_join_algorithm = {algorithm}")

    # Warmup: compile kernels for this shape bucket.
    total = int(ctx.sql(QUERY).column_np(0)[0])
    times = []
    # run at least `iters` and keep sampling up to a small wall budget so
    # min-of-N reflects the steady state, not one noisy sample
    budget_end = time.perf_counter() + max(iters * 0.3, 3.0)
    while len(times) < iters or (
        time.perf_counter() < budget_end and len(times) < 48
    ):
        gc.collect()
        t0 = time.perf_counter()
        got = int(ctx.sql(QUERY).column_np(0)[0])
        times.append(time.perf_counter() - t0)
        assert got == total
    t = min(times)
    if verbose:
        print(
            f"alg={algorithm}: {total:,} output rows, "
            f"min {t*1000:.1f} ms / median {sorted(times)[len(times)//2]*1000:.1f} ms "
            f"-> {total/t/1e6:.0f}M rows/s",
            file=sys.stderr,
        )
    if not stages:
        return total, t
    return total, t, _stage_breakdown(ctx, times)


def _stage_breakdown(ctx, times):
    """Per-stage timing of the headline count: separates host encode,
    device program (dispatch + compute + result fetch), and the bare
    host<->device round trip — so a headline regression is attributable
    to the link vs device compute vs host work."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pyarrow as pa

    from sequila_tpu.models.table import Table
    from sequila_tpu.ops.interval_index import _bucket
    from sequila_tpu.ops.interval_join import counts_bits_fused

    out = {
        "iters_ms": [round(t * 1000, 2) for t in times],
        "median_ms": round(sorted(times)[len(times) // 2] * 1000, 2),
    }
    # bare link round trip: ship one scalar down and back
    one = jnp.zeros((8,), jnp.int32)
    np.asarray(one + 1)
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(jax.device_put(np.zeros(8, np.int32)) + 1)
        rtts.append(time.perf_counter() - t0)
    out["link_rtt_ms"] = round(min(rtts) * 1000, 2)
    # host encode of fresh (uncached) tables
    t1 = pa.table(gen_chain_table(N_LEFT, seed=91))
    t2 = pa.table(gen_chain_table(N_RIGHT, seed=92))
    t0 = time.perf_counter()
    T1, T2 = Table(t1), Table(t2)
    T1.dict_codes(0), T2.dict_codes(0)
    T1.column_as_i32(1), T1.column_as_i32(2)
    T2.column_as_i32(1), T2.column_as_i32(2)
    out["host_encode_ms"] = round((time.perf_counter() - t0) * 1000, 2)
    # warm device program (the steady-state iteration body)
    lt = ctx.catalog["s1"]
    rt = ctx.catalog["s2"]
    lk = lt.dict_codes(0)[2] * 0
    rk = rt.dict_codes(0)[2] * 0
    args = (
        lk, lt.device_i32(1), lt.device_i32(2),
        rk, rt.device_i32(1), rt.device_i32(2),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
    )
    n_pad = _bucket(max(lt.num_rows, 1), minimum=1024)
    m_pad = _bucket(max(rt.num_rows, 1), minimum=1024)
    np.asarray(counts_bits_fused(*args, n_pad=n_pad, m_pad=m_pad))
    devs = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(counts_bits_fused(*args, n_pad=n_pad, m_pad=m_pad))
        devs.append(time.perf_counter() - t0)
    out["device_program_ms"] = round(min(devs) * 1000, 2)
    out["device_compute_ms"] = round(
        (min(devs) - min(rtts)) * 1000, 2
    )
    return out


def gen_genome_table(n, seed, num_contigs=24, median_len=5_000, sigma=1.2):
    """Whole-genome-like table: contig sizes follow a realistic skew
    (chr1 largest), lognormal interval lengths."""
    rng = np.random.default_rng(seed)
    sizes = np.array([248 - 8 * i for i in range(num_contigs)], np.float64)
    probs = sizes / sizes.sum()
    contig_ids = rng.choice(num_contigs, n, p=probs)
    spans = (sizes * 1e6).astype(np.int64)
    starts = (rng.random(n) * spans[contig_ids]).astype(np.int64)
    lens = np.exp(rng.normal(np.log(median_len), sigma, n)).astype(np.int64)
    ends = np.minimum(starts + np.maximum(lens, 1), 2**31 - 2)
    return {
        "contig": np.array([f"chr{i+1}" for i in contig_ids]),
        "pos_start": starts,
        "pos_end": ends,
    }


def run_pair(name, t1, t2, iters, query=QUERY, setup_sql=(), results=None):
    import pyarrow as pa

    from sequila_tpu.session import SessionContext

    ctx = SessionContext()
    ctx.register_table("s1", pa.table(t1))
    ctx.register_table("s2", pa.table(t2))
    ctx.sql("SET sequila.prefer_interval_join = true")
    for s in setup_sql:
        ctx.sql(s)
    first = ctx.sql(query)
    import gc

    times = []
    out = None
    for _ in range(iters):
        out = None
        gc.collect()  # drop the previous output so its pages recycle
        t0 = time.perf_counter()
        out = ctx.sql(query)
        times.append(time.perf_counter() - t0)
    t = min(times)
    total = int(out.column_np(0)[0]) if out.num_rows == 1 and len(out.column_names) == 1 else out.num_rows
    print(
        f"{name}: {total:,} rows, {t*1000:.1f} ms -> "
        f"{total/max(t,1e-9)/1e6:.0f}M rows/s",
        file=sys.stderr,
    )
    if results is not None:
        results[name] = {
            "rows": total,
            "seconds": round(t, 5),
            "rows_per_sec": round(total / max(t, 1e-9)),
        }
    return total, t


FULL_ARTIFACT = "BENCH_full.json"


def run_full(iters, device=None):
    """databio-style suite: multiple pairings (reference
    benches/databio_benchmark.rs runs 9 tables x 5 pairings), algorithm
    sweep, whole-genome skewed join, and a materialization bench.

    Every number is also recorded machine-readably in BENCH_full.json so
    the regression gate can watch the non-default algorithms and the
    materialization path, not just the headline pairing."""
    artifact = {
        "suite": "databio-style synthetic",
        "device": device,
        "iters": iters,
        "algorithms": {},
        "pairings": {},
        "genomic_ops": {},
    }
    print("== algorithm sweep (chr1 pair) ==", file=sys.stderr)
    for alg in (
        "coitrees", "intervaltree", "arrayintervaltree", "lapper",
        "superintervals",
    ):
        total, t = run(alg, iters=iters, verbose=True)
        artifact["algorithms"][alg] = {
            "rows": total,
            "seconds": round(t, 5),
            "rows_per_sec": round(total / max(t, 1e-9)),
        }

    print("== pairings ==", file=sys.stderr)
    pairs = [
        ("Small-Small  (20k x 20k)", gen_chain_table(20_000, 11), gen_chain_table(20_000, 12)),
        ("Small-Medium (20k x 300k)", gen_chain_table(20_000, 13), gen_chain_table(N_RIGHT, 14)),
        ("Medium-Medium(207k x 302k)", gen_chain_table(N_LEFT, 1), gen_chain_table(N_RIGHT, 2)),
        ("Genome-Genome(2.3M x 7.7M)", gen_genome_table(2_350_965, 21), gen_genome_table(7_684_066, 22)),
    ]
    for name, t1, t2 in pairs:
        run_pair(name, t1, t2, iters, results=artifact["pairings"])
    del pairs

    # the reference's 5-pairing databio matrix (databio_benchmark.rs:
    # 148-246: chainRn4 x {fBrain, chainOrnAna1, ex-anno, ex-rna} and
    # ex-anno x ex-rna) with synthetic stand-ins at the real tables' row
    # counts — the real parquet files are absent from the snapshot
    # (.MISSING_LARGE_BLOBS) and the image has no egress.  Chain tables:
    # long lognormal alignments; fBrain/ex-*: short reads/exons.
    print("== databio 5-pairing matrix (synthetic at real row counts) ==",
          file=sys.stderr)
    chainRn4 = gen_genome_table(2_350_965, 81, median_len=40_000, sigma=1.4)
    databio = [
        ("chainRn4 x fBrain (2.35M x 199k)",
         chainRn4, gen_genome_table(199_120, 82, median_len=150, sigma=0.3)),
        ("chainRn4 x chainOrnAna1 (2.35M x 1.96M)",
         chainRn4, gen_genome_table(1_957_027, 83, median_len=40_000, sigma=1.4)),
        ("chainRn4 x ex-anno (2.35M x 1.19M)",
         chainRn4, gen_genome_table(1_194_285, 84, median_len=300, sigma=0.8)),
        ("chainRn4 x ex-rna (2.35M x 9.9M)",
         chainRn4, gen_genome_table(9_945_244, 85, median_len=150, sigma=0.4)),
        ("ex-anno x ex-rna (1.19M x 9.9M)",
         gen_genome_table(1_194_285, 84, median_len=300, sigma=0.8),
         gen_genome_table(9_945_244, 85, median_len=150, sigma=0.4)),
    ]
    artifact["databio_pairings"] = {}
    for name, t1, t2 in databio:
        run_pair(name, t1, t2, max(3, iters // 2),
                 results=artifact["databio_pairings"])
    # drop the ~2 GB of generated tables: holding them through the rest
    # of the suite fragments the retained heap and the later
    # materialization sections measure page-fault churn instead of the
    # engine (mat15 regressed 192 -> 43 M rows/s in one run from this)
    del databio, chainRn4, t1, t2
    import gc as _gc

    _gc.collect()

    print("== chromosome-subset + filter pushdown (q1-lapper config) ==", file=sys.stderr)
    run_pair(
        "genome chr1-filtered lapper",
        gen_genome_table(500_000, 31),
        gen_genome_table(500_000, 32),
        iters,
        query=(
            "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
            "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end "
            "WHERE a.contig = 'chr1'"
        ),
        setup_sql=["SET sequila.interval_join_algorithm = lapper"],
        results=artifact["pairings"],
    )

    print("== genomic operators (BASELINE configs 3-4) ==", file=sys.stderr)
    import pyarrow as pa
    from sequila_tpu import dataframe as gdf
    from sequila_tpu.models.table import Table
    A = Table(pa.table(gen_genome_table(500_000, 61)))
    B = Table(pa.table(gen_genome_table(500_000, 62)))
    def _timed_op(name, fn, results):
        import gc

        fn()  # warm
        best, out = None, None
        for _ in range(max(2, iters // 2)):
            out = None
            gc.collect()
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(f"{name}: {out.num_rows:,} rows in {best*1000:.0f} ms", file=sys.stderr)
        results[name] = {"rows": out.num_rows, "seconds": round(best, 4)}

    for name, fn in [
        ("coverage (500k x 500k)", lambda: gdf.coverage(A, B)),
        ("count_overlaps (500k x 500k)", lambda: gdf.count_overlaps(A, B)),
        ("closest k=1 (500k x 500k)", lambda: gdf.closest(A, B, k=1)),
        ("closest k=3 (500k x 500k)", lambda: gdf.closest(A, B, k=3)),
        ("merge (500k)", lambda: gdf.merge(A)),
        ("complement (500k)", lambda: gdf.complement(A, {f"chr{i+1}": (0, 248_000_000) for i in range(24)})),
        ("subtract (500k x 500k)", lambda: gdf.subtract(A, B)),
        ("depth/pileup (500k)", lambda: gdf.depth(A)),
        ("window w=5k (500k x 500k)", lambda: gdf.window(A, B, window=5_000)),
        ("reldist (500k x 500k)", lambda: gdf.reldist(A, B)),
        ("overlap/materialize (500k x 500k)", lambda: gdf.overlap(A, B)),
    ]:
        _timed_op(name, fn, artifact["genomic_ops"])

    print("== genomic operators at genome scale (2.3M x 7.7M) ==", file=sys.stderr)
    AG = Table(pa.table(gen_genome_table(2_350_965, 21)))
    BG = Table(pa.table(gen_genome_table(7_684_066, 22)))
    artifact["genomic_ops_genome"] = {}
    for name, fn in [
        ("coverage (2.3M x 7.7M)", lambda: gdf.coverage(AG, BG)),
        ("count_overlaps (2.3M x 7.7M)", lambda: gdf.count_overlaps(AG, BG)),
        ("subtract (2.3M x 7.7M)", lambda: gdf.subtract(AG, BG)),
        ("nearest/closest k=1 (2.3M x 7.7M)", lambda: gdf.closest(AG, BG, k=1)),
    ]:
        _timed_op(name, fn, artifact["genomic_ops_genome"])
    del AG, BG

    print("== strand-aware verbs ==", file=sys.stderr)
    As = Table(A.arrow.append_column(
        "strand", pa.array([["+", "-"][i % 2] for i in range(A.num_rows)])
    ))
    Bs = Table(B.arrow.append_column(
        "strand", pa.array([["+", "-"][i % 2] for i in range(B.num_rows)])
    ))
    for name, fn in [
        ("count_overlaps -s (500k x 500k)",
         lambda: gdf.count_overlaps(As, Bs, strand="same")),
        ("merge -s (500k)", lambda: gdf.merge(As, strand=True)),
    ]:
        _timed_op(name, fn, artifact["genomic_ops"])

    print("== host SQL layer (500k rows) ==", file=sys.stderr)
    from sequila_tpu.session import SessionContext as _SC

    rng = np.random.default_rng(0)
    n = 500_000
    sc = _SC()
    sc.register_table("hb", pa.table({
        "g": pa.array(np.array([f"chr{i % 23}" for i in range(n)], dtype=object)),
        "x": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
        "y": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.random(n))),
    }))
    artifact["sql_host"] = {}
    for name, q in [
        ("group-aggregate", "SELECT g, count(*), sum(x), avg(y) FROM hb GROUP BY g"),
        ("order-by-string", "SELECT g FROM hb ORDER BY g DESC"),
        ("string-functions", "SELECT upper(g), length(g), contains(g, '1') FROM hb"),
        ("window-function", "SELECT x, row_number() OVER (PARTITION BY g ORDER BY x) FROM hb"),
    ]:
        sc.sql(q)  # warm
        t0 = time.perf_counter()
        sc.sql(q)
        dt = time.perf_counter() - t0
        print(f"{name}: {dt*1000:.0f} ms", file=sys.stderr)
        artifact["sql_host"][name] = {"seconds": round(dt, 4)}

    print("== materialization (SELECT *, 20k x 20k) ==", file=sys.stderr)
    run_pair(
        "materialize",
        gen_chain_table(20_000, 41, median_len=20_000),
        gen_chain_table(20_000, 42, median_len=20_000),
        iters,
        query=(
            "SELECT a.pos_start, b.pos_end FROM s1 a JOIN s2 b "
            "ON a.contig = b.contig AND a.pos_end >= b.pos_start "
            "AND a.pos_start <= b.pos_end"
        ),
        results=artifact["pairings"],
    )
    print("== materialization at scale (SELECT *, 20k x 300k -> ~15M rows) ==",
          file=sys.stderr)
    run_pair(
        "materialize 15M rows",
        gen_chain_table(20_000, 13),
        gen_chain_table(300_000, 14),
        max(3, iters // 2),
        query=(
            "SELECT * FROM s1 a JOIN s2 b "
            "ON a.contig = b.contig AND a.pos_end >= b.pos_start "
            "AND a.pos_start <= b.pos_end"
        ),
        results=artifact["pairings"],
    )
    print("== streaming delivery (batch-iterator + COPY sink, 154M rows) ==",
          file=sys.stderr)
    artifact["copy_stream"] = run_stream_bench()

    print("== native host index vs NumPy (VERDICT r2 #6) ==", file=sys.stderr)
    artifact["native_host"] = run_native_host_bench()

    print("== Partitioned/SPMD on this backend (VERDICT r2 #7) ==", file=sys.stderr)
    artifact["partitioned_mesh"] = run_partitioned_backend(iters)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), FULL_ARTIFACT)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(f"full-suite artifact written to {path}", file=sys.stderr)


def run_stream_bench():
    """Streaming result delivery at full-genome scale (VERDICT r3 #1):
    the canonical 154M-row SELECT * consumed through sql_batches (bounded
    batches, never the whole table) and COPY'd to a partitioned parquet
    directory through the incremental writer pool.  Records rows/s and
    peak RSS — the point is bounded memory at streaming speed (the old
    whole-table materialization was RSS-bound at ~8M rows/s and held the
    full 7.4 GB result).

    Runs in this process, because one process holds the card:
    ``process_peak_rss_gb`` is the process's lifetime maximum, so under
    --full it includes the earlier sections' peak."""
    import gc
    import resource
    import shutil
    import tempfile

    import pyarrow as pa

    from sequila_tpu.session import SessionContext

    ctx = SessionContext()
    ctx.register_table("s1", pa.table(gen_chain_table(N_LEFT, seed=1)))
    ctx.register_table("s2", pa.table(gen_chain_table(N_RIGHT, seed=2)))
    q = (
        "SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
        "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
    )
    ctx.sql("SET sequila.max_output_batch_size = 1000000")
    results = {}
    # producer-only: the batch iterator end to end
    n = sum(t.num_rows for t in ctx.sql_batches(q))  # warm
    gc.collect()
    t0 = time.perf_counter()
    n = sum(t.num_rows for t in ctx.sql_batches(q))
    dt = time.perf_counter() - t0
    results["sql_batches"] = {
        "rows": n, "seconds": round(dt, 3),
        "rows_per_sec": round(n / max(dt, 1e-9)),
    }
    print(f"sql_batches SELECT * ({n:,} rows): {dt:.2f}s -> "
          f"{n/dt/1e6:.1f}M rows/s", file=sys.stderr)
    # streamed COPY to a partitioned parquet directory.  Warm with a
    # LIMIT subset (compiles/caches the sink without dumping 4.9 GB of
    # dirty pages whose writeback throttles the measured run), then sync
    # so the measurement starts with a clean page cache.
    out_dir = tempfile.mkdtemp(prefix="sequila_copy_") + "/"
    try:
        ctx.sql(
            f"COPY (SELECT * FROM ({q}) LIMIT 2000000) TO '{out_dir}' "
            "STORED AS PARQUET"
        )
        shutil.rmtree(out_dir, ignore_errors=True)
        # min of two measured runs: disk writeback throttling swings
        # single-run times 2-5x minute to minute
        dt = None
        for _ in range(2):
            os.makedirs(out_dir, exist_ok=True)
            os.sync()
            gc.collect()
            t0 = time.perf_counter()
            got = int(
                ctx.sql(
                    f"COPY ({q}) TO '{out_dir}' STORED AS PARQUET"
                ).column_np(0)[0]
            )
            run = time.perf_counter() - t0
            dt = run if dt is None else min(dt, run)
            shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    assert got == n
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    results["copy_parquet_dir"] = {
        "rows": n, "seconds": round(dt, 3),
        "rows_per_sec": round(n / max(dt, 1e-9)),
        "process_peak_rss_gb": round(rss_gb, 2),
    }
    print(f"COPY -> parquet dir ({n:,} rows): {dt:.2f}s -> "
          f"{n/dt/1e6:.1f}M rows/s, peak RSS {rss_gb:.1f} GB "
          f"(result itself is ~7.4 GB)", file=sys.stderr)
    return results


def run_native_host_bench():
    """Native C++ host index vs the NumPy fallback at 1M and 10M rows —
    the measured comparison VERDICT r2 asked for (reference ships
    SIMD count loops, superintervals.rs:395-638; ours ships threaded
    segment-local binary searches — this records the actual ratio)."""
    import gc

    from sequila_tpu.native.loader import available
    from sequila_tpu.ops.host_join import HostIntervalIndex, make_host_index

    results = {"native_available": available()}
    for n, m in ((1_000_000, 1_000_000), (10_000_000, 2_000_000)):
        t1 = gen_genome_table(n, 71)
        t2 = gen_genome_table(m, 72)
        enc = {f"chr{i+1}": i for i in range(24)}
        lk = np.array([enc[c] for c in t1["contig"]], np.int32)
        rk = np.array([enc[c] for c in t2["contig"]], np.int32)
        ls, le = t1["pos_start"].astype(np.int32), t1["pos_end"].astype(np.int32)
        rs, re = t2["pos_start"].astype(np.int32), t2["pos_end"].astype(np.int32)
        row = {}
        for tag, make in (
            ("native", make_host_index),
            ("numpy", HostIntervalIndex),
        ):
            if tag == "native" and not available():
                continue
            gc.collect()
            t0 = time.perf_counter()
            idx = make(lk, ls, le)
            row[f"{tag}_build_s"] = round(time.perf_counter() - t0, 4)
            counts = idx.counts(rk, rs, re)  # warm
            t0 = time.perf_counter()
            counts = idx.counts(rk, rs, re)
            row[f"{tag}_count_s"] = round(time.perf_counter() - t0, 4)
            row[f"{tag}_count_mqps"] = round(m / max(row[f"{tag}_count_s"], 1e-9) / 1e6, 1)
            total = int(np.asarray(counts).sum())
            row["total_pairs"] = total
            # pairs emission: the numpy fallback's repeat/gather chain is
            # ~0.2M rows/s at the 10M scale (515 s measured once, r3) —
            # cap it so the suite stays runnable; native has no cap here
            if total < 200_000_000 and (tag == "native" or total < 20_000_000):
                t0 = time.perf_counter()
                b, p = idx.pairs(rk, rs, re)
                row[f"{tag}_pairs_s"] = round(time.perf_counter() - t0, 4)
                row[f"{tag}_pairs_mrows"] = round(
                    len(b) / max(row[f"{tag}_pairs_s"], 1e-9) / 1e6, 1
                )
                del b, p
            del idx
        name = f"{n//1_000_000}Mx{m//1_000_000}M"
        results[name] = row
        print(f"{name}: {row}", file=sys.stderr)
    return results


def run_partitioned_backend(iters):
    """Partitioned/SPMD execution on the attached backend (a mesh of the
    attached devices): proves the shard_map programs compile and run on
    hardware, across all four distributions."""
    import pyarrow as pa

    from sequila_tpu.session import SessionContext

    ctx = SessionContext()
    ctx.register_table("s1", pa.table(gen_genome_table(100_000, 81)))
    ctx.register_table("s2", pa.table(gen_genome_table(150_000, 82)))
    ctx.sql("SET datafusion.execution.target_partitions = 8")
    results = {}
    want = None
    for dist in ("auto", "hash", "shuffle", "skew"):
        ctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        total = int(ctx.sql(QUERY).column_np(0)[0])
        if want is None:
            want = total
        assert total == want, (dist, total, want)
        times = []
        for _ in range(max(2, iters // 2)):
            t0 = time.perf_counter()
            got = int(ctx.sql(QUERY).column_np(0)[0])
            times.append(time.perf_counter() - t0)
            assert got == want
        results[dist] = {
            "rows": total,
            "seconds": round(min(times), 4),
            "rows_per_sec": round(total / max(min(times), 1e-9)),
        }
        print(f"partitioned[{dist}]: {total:,} rows in {min(times):.3f} s",
              file=sys.stderr)
    return results


# -- real databio data (reference benches/databio_benchmark.rs) --------------
#
# One-command protocol when the databio parquet blobs are available (they
# are absent from this image — zero egress):
#
#   BENCH_DATA_ROOT=/data/bench_data/databio python bench.py --databio
#
# Layout (reference databio_benchmark.rs:147,257): {root}/{table}/*.parquet
# for tables chainRn4, fBrain-DS14718, chainOrnAna1, ex-anno, ex-rna (the 5
# reference pairings), plus optionally chainRn4_chr1 / chainVicPac2_chr1 to
# reproduce the 154,374,873-row correctness anchor
# (reference sandbox/datafusion_baseline.md:8) — asserted exactly.

DATABIO_PAIRINGS = [
    ("chainRn4", "fBrain-DS14718"),
    ("chainRn4", "chainOrnAna1"),
    ("chainRn4", "ex-anno"),
    ("chainRn4", "ex-rna"),
    ("ex-anno", "ex-rna"),
]
ANCHOR_PAIR = ("chainRn4_chr1", "chainVicPac2_chr1")
ANCHOR_ROWS = 154_374_873


def run_databio(iters):
    import pyarrow.dataset as pds

    from sequila_tpu.session import SessionContext

    root = os.environ.get("BENCH_DATA_ROOT", "/data/bench_data/databio/")
    if not os.path.isdir(root):
        print(
            f"BENCH_DATA_ROOT {root} not found — databio parquet data is "
            "not in this image; see the protocol comment in bench.py",
            file=sys.stderr,
        )
        return

    def load(name):
        return pds.dataset(os.path.join(root, name)).to_table()

    artifact = {"suite": "databio", "root": root, "iters": iters, "results": {}}
    pairings = list(DATABIO_PAIRINGS)
    if all(os.path.isdir(os.path.join(root, t)) for t in ANCHOR_PAIR):
        pairings.insert(0, ANCHOR_PAIR)
    for s1, s2 in pairings:
        if not all(os.path.isdir(os.path.join(root, t)) for t in (s1, s2)):
            print(f"skipping {s1} x {s2} (missing data)", file=sys.stderr)
            continue
        ctx = SessionContext()
        ctx.register_table("s1", load(s1))
        ctx.register_table("s2", load(s2))
        for alg in ("coitrees", "intervaltree", "arrayintervaltree", "lapper"):
            ctx.sql(f"SET sequila.interval_join_algorithm = {alg}")
            total = int(ctx.sql(QUERY).column_np(0)[0])
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                got = int(ctx.sql(QUERY).column_np(0)[0])
                times.append(time.perf_counter() - t0)
                assert got == total
            t = min(times)
            name = f"{s1}x{s2}:{alg}"
            print(f"{name}: {total:,} rows in {t:.3f} s", file=sys.stderr)
            artifact["results"][name] = {"rows": total, "seconds": round(t, 4)}
            if (s1, s2) == ANCHOR_PAIR:
                assert total == ANCHOR_ROWS, (
                    f"anchor mismatch: {total} != {ANCHOR_ROWS}"
                )
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BENCH_databio.json"
    )
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
    print(f"databio artifact written to {path}", file=sys.stderr)


def run_pipeline(k=8):
    """Amortized multi-query throughput: K distinct count queries batched
    into ONE device program with one result fetch.

    Single-query wall time includes a host<->device round trip per
    query (pipelined dispatches serialize on result fetches), so this
    batches queries: the per-query amortized time approximates the
    device compute."""
    import jax
    import jax.numpy as jnp

    from sequila_tpu.ops.interval_index import PAD_KEY, PAD_VAL, _bucket
    from sequila_tpu.ops.interval_join import _sum_rank_partials

    t1 = gen_chain_table(N_LEFT, 1)
    npad = _bucket(N_LEFT, minimum=1024)
    mpad = _bucket(N_RIGHT, minimum=1024)

    def padded(a, fill, size):
        out = np.full(size, fill, np.int32)
        out[: len(a)] = a
        return out

    bk = jnp.asarray(padded(np.zeros(N_LEFT, np.int32), PAD_KEY, npad))
    bs = jnp.asarray(padded(t1["pos_start"].astype(np.int32), PAD_VAL, npad))
    be = jnp.asarray(padded(t1["pos_end"].astype(np.int32), PAD_VAL, npad))
    QK, QS, QE = [], [], []
    for sd in range(k):
        t2 = gen_chain_table(N_RIGHT, 100 + sd)
        QK.append(padded(np.zeros(N_RIGHT, np.int32), PAD_KEY, mpad))
        QS.append(padded(t2["pos_start"].astype(np.int32), PAD_VAL, mpad))
        QE.append(padded(t2["pos_end"].astype(np.int32), PAD_VAL - 2, mpad))
    QKd = jnp.asarray(np.stack(QK))
    QSd = jnp.asarray(np.stack(QS))
    QEd = jnp.asarray(np.stack(QE))

    @jax.jit
    def batched_counts(bk, bs, be, QK, QS, QE):
        def one(qk, qs, qe):
            pu = _sum_rank_partials(bk, bs, qk, qe, side="right")
            pl_ = _sum_rank_partials(bk, be, qk, qs, side="left")
            return jnp.concatenate([pu, -pl_])

        return jax.vmap(one)(QK, QS, QE)

    np.asarray(batched_counts(bk, bs, be, QKd, QSd, QEd))  # warm
    t0 = time.perf_counter()
    out = np.asarray(batched_counts(bk, bs, be, QKd, QSd, QEd)).astype(np.int64)
    dt = time.perf_counter() - t0
    totals = out.sum(axis=1)
    print(
        f"batched {k} distinct count queries in one program: {dt*1000:.1f} ms"
        f" -> {dt/k*1000:.1f} ms/query amortized"
        f" ({float(totals.mean())/ (dt/k) / 1e9:.1f}B output rows/s device throughput)",
        file=sys.stderr,
    )


def run_scaling():
    """Partitioned-join scaling efficiency on a virtual 8-device CPU mesh
    (multi-chip hardware is not attached; this validates the SPMD path's
    scaling shape, not absolute ICI throughput).  Writes the
    machine-readable BENCH_scaling.json artifact so rounds can be
    compared (VERDICT r2 #8)."""
    import subprocess

    code = r"""
import json, os, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS","") + " --xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from bench import gen_genome_table
from sequila_tpu.parallel.mesh import make_mesh
t1 = gen_genome_table(400_000, 51)
t2 = gen_genome_table(400_000, 52)
enc = {f"chr{i+1}": i for i in range(24)}
lk = np.array([enc[c] for c in t1["contig"]], np.int32)
rk = np.array([enc[c] for c in t2["contig"]], np.int32)
ls, le = t1["pos_start"].astype(np.int32), t1["pos_end"].astype(np.int32)
rs, re = t2["pos_start"].astype(np.int32), t2["pos_end"].astype(np.int32)
artifact = {"suite": "virtual-8-device CPU mesh scaling",
            "note": ("SPMD device step only, data pre-partitioned and "
                     "placed: on a real pod the shuffle is itself "
                     "distributed; here it is one serial python process "
                     "and would swamp the measurement.  Efficiency above "
                     "the physical core count measures oversubscription, "
                     "not the algorithm.  'devices' = the co-sort "
                     "strategy (the gated >=70% floor); "
                     "'devices_bsearch' = the default strategy, ~20x "
                     "faster absolute step times whose relative "
                     "efficiency is dispatch-bound at this problem "
                     "size."),
            "host_cores": os.cpu_count(),
            "rows": [int(len(lk)), int(len(rk))], "devices": {}}
# Time ONLY the SPMD device step (data pre-partitioned and placed).
from jax.sharding import NamedSharding, PartitionSpec as P
from sequila_tpu.parallel.partitioned_join import (
    build_partitioned_index, partition_probe, partitioned_count_fn,
)
# Two strategies per device count: 'sort' (the per-shard co-sort, whose
# compute-dense step is the meaningful SCALING-SHAPE measurement on an
# oversubscribed host; its efficiency rows are the gated >=70% floor) and
# 'bsearch' (the default — ~23x faster in absolute step time, so fast at
# this problem size that fixed per-step dispatch dominates and relative
# efficiency stops measuring the algorithm; recorded as absolutes).
artifact["devices_bsearch"] = {}
for strategy, sink in (("sort", "devices"), ("bsearch", "devices_bsearch")):
    base = None
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n)
        npart, nprobe = mesh.shape["part"], mesh.shape["probe"]
        arrays, meta = build_partitioned_index(lk, ls, le, npart)
        K, S, E, _ = partition_probe(rk, rs, re, npart, nprobe)
        dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
        args = (
            dev(arrays["levels"], P("part", None)), dev(arrays["keys"], P("part", None)),
            dev(arrays["starts"], P("part", None)), dev(arrays["ends"], P("part", None)),
            dev(K, P("part", "probe", None)), dev(S, P("part", "probe", None)),
            dev(E, P("part", "probe", None)),
        )
        fn = partitioned_count_fn(
            mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
            strategy,
        )
        fn(*args).block_until_ready()  # compile
        reps, best = 3, None
        for _ in range(reps):
            t0 = time.perf_counter()
            total = fn(*args)
            total.block_until_ready()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        dt = best
        if base is None:
            base = dt
        eff = base / (dt * n) * 100
        # the count fn returns int32-safe bucket partials; finish in int64
        tot = int(np.asarray(total).astype(np.int64).sum())
        artifact[sink][str(n)] = {
            "spmd_step_ms": round(dt * 1000, 2), "total": tot,
            "efficiency_pct": round(eff, 1),
        }
        print(f"devices={n} [{strategy}]: SPMD step {dt*1000:.1f} ms, "
              f"total={tot}, scaling efficiency={eff:.0f}%")

# skew-vs-hash comparison (range-split hot contigs) at 8 devices, and the
# device all_to_all shuffle, end-to-end (incl. host planning, post-compile)
from sequila_tpu.parallel.skew import skew_partitioned_count_mesh
from sequila_tpu.parallel.shuffle import all_to_all_partitioned_count
from sequila_tpu.parallel.partitioned_join import partitioned_count
mesh = make_mesh(8)
flat = make_mesh(8, part=8)
for name, fn in (
    ("hash", lambda: partitioned_count(mesh, lk, ls, le, rk, rs, re)),
    ("skew", lambda: skew_partitioned_count_mesh(mesh, lk, ls, le, rk, rs, re)),
    ("shuffle", lambda: all_to_all_partitioned_count(flat, lk, ls, le, rk, rs, re)),
):
    total = fn()  # compile + warm
    t0 = time.perf_counter()
    total = fn()
    dt = time.perf_counter() - t0
    artifact[f"e2e_8dev_{name}"] = {"seconds": round(dt, 3), "total": int(total)}
    print(f"{name} 8 devices end-to-end (warm): {dt:.3f} s, total={total}")

path = os.path.join(os.getcwd(), "BENCH_scaling.json")  # cwd = repo root
with open(path, "w") as f:
    json.dump(artifact, f, indent=1, sort_keys=True)
print(f"scaling artifact written to {path}")
"""
    subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)))


def device_info() -> dict:
    """The device every artifact records.  The bench measures a GPU: with
    none attached it stops, unless JAX_PLATFORMS=cpu asked for the CPU."""
    import shutil
    import subprocess

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"bench: JAX found no GPU (platform {platform!r}); set "
            "JAX_PLATFORMS=cpu to measure the CPU on purpose"
        )
    card = None
    if platform == "gpu" and shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip().splitlines()[0]
    return {
        "platform": platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="run the full databio-style suite")
    ap.add_argument("--scaling", action="store_true", help="virtual-mesh scaling check")
    ap.add_argument("--pipeline", action="store_true", help="sustained async throughput")
    ap.add_argument(
        "--databio", action="store_true",
        help="run the reference's real databio parquet suite (BENCH_DATA_ROOT)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="re-run ONLY the streaming/COPY section and update its "
             "entry in BENCH_full.json (the section's disk-writeback "
             "sensitivity makes isolated refreshes useful)",
    )
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    if args.scaling:
        run_scaling()  # CPU-only virtual mesh in a CPU-pinned child
        return
    device = device_info()
    if args.pipeline:
        run_pipeline()
        return
    if args.databio:
        run_databio(args.iters)
        return
    if args.stream:
        results = run_stream_bench()
        path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), FULL_ARTIFACT
        )
        artifact = json.load(open(path))
        artifact["copy_stream"] = results
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
        print(f"copy_stream refreshed in {path}", file=sys.stderr)
        return
    if args.full:
        run_full(args.iters, device)

    # headline: min over a larger iter count plus a per-stage breakdown
    # so regressions are attributable.
    total, t, stages = run(
        "coitrees", iters=max(args.iters, 9), verbose=args.full, stages=True
    )
    mat_rows, mat_t = run_pair(
        "materialize-15M (headline)",
        gen_chain_table(20_000, 13),
        gen_chain_table(300_000, 14),
        max(5, args.iters),  # min-of-5+: first-allocation churn swings
                             # single runs ~2x (page faults into the
                             # retained heap); later runs recycle
        query=(
            "SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
            "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
        ),
    )
    value = total / t
    print(
        json.dumps(
            {
                "metric": "interval_join_output_rows_per_sec",
                "value": round(value),
                "unit": "output_rows_per_sec",
                "vs_baseline": round(value / BASELINE_ROWS_PER_SEC, 3),
                "detail": {
                    "query": "databio count(*) chainRn4_chr1-like x chainVicPac2_chr1-like",
                    "output_rows": total,
                    "seconds": round(t, 4),
                    "device": device,
                    "baseline": "sequila-native Coitrees 154.37M rows / 2.457 s (BASELINE.md)",
                    "stages": stages,
                    "materialize_rows_per_sec": round(mat_rows / max(mat_t, 1e-9)),
                    "materialize_rows": mat_rows,
                    "materialize_seconds": round(mat_t, 4),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
