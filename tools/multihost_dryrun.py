"""REAL multi-process distributed validation (2 processes x 4 CPU devices).

The driver's `dryrun_multichip` certifies the SPMD programs on a virtual
8-device mesh inside ONE process; this script goes one step further and
runs the same partitioned interval-join programs across TWO OS processes
joined by `jax.distributed.initialize` (Gloo collectives over localhost —
the same client/coordinator path a multi-host GPU cluster uses).
That exercises what the single-process dryrun cannot: cross-process
device_put of host data onto a global mesh, collectives spanning
non-addressable devices, and replicated-output fetches.

Run:  python tools/multihost_dryrun.py            (spawns both workers)
      python tools/multihost_dryrun.py <pid>      (worker entry)

Writes MULTIHOST.json at the repo root on success.

Role in the reference map: the reference is single-process (SURVEY.md §2
"Distributed comm backend: none"); this validates the engine's
jax.distributed layer (parallel/distributed.py) end to end.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = int(os.environ.get("SEQUILA_MH_PORT", "29877"))
NPROC = 2
LOCAL_DEVICES = 4


def worker(pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from sequila_tpu.parallel.distributed import initialize

    initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NPROC,
        process_id=pid,
    )
    assert len(jax.devices()) == NPROC * LOCAL_DEVICES
    import numpy as np

    from jax.sharding import Mesh

    from sequila_tpu.ops.oracle import oracle_counts, oracle_pairs
    from sequila_tpu.parallel.partitioned_join import (
        collect_left_count,
        partitioned_count,
        partitioned_pairs,
        partitioned_probe_counts,
    )
    from sequila_tpu.parallel.shuffle import (
        all_to_all_partitioned_count,
        all_to_all_partitioned_pairs,
    )
    from sequila_tpu.parallel.skew import skew_partitioned_count_mesh

    mesh = Mesh(
        np.array(jax.devices()).reshape(NPROC, LOCAL_DEVICES),
        ("part", "probe"),
    )
    results = {}

    # identical data generated in every process (multi-host convention:
    # each host holds the global table view; device_put ships only the
    # shards its local devices own)
    rng = np.random.default_rng(7)
    for label, n, m, hot in (("toy", 512, 1024, 0.0), ("skewed", 20_000, 30_000, 0.9)):
        lk = rng.integers(0, 16, n).astype(np.int32)
        rk = rng.integers(0, 17, m).astype(np.int32)
        if hot:
            lk[rng.random(n) < hot] = 3
            rk[rng.random(m) < hot] = 3
        ls = rng.integers(0, 100_000, n).astype(np.int32)
        le = ls + rng.integers(0, 500, n).astype(np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        re = rs + rng.integers(0, 500, m).astype(np.int32)
        want = int(oracle_counts(lk, ls, le, rk, rs, re).sum())
        got = partitioned_count(mesh, lk, ls, le, rk, rs, re)
        assert got == want, f"{label}: partitioned {got} != {want}"
        got_cl = collect_left_count(mesh, lk, ls, le, rk, rs, re)
        assert got_cl == want, f"{label}: collect-left {got_cl} != {want}"
        got_sh = all_to_all_partitioned_count(mesh, lk, ls, le, rk, rs, re)
        assert got_sh == want, f"{label}: shuffle {got_sh} != {want}"
        pc = partitioned_probe_counts(mesh, lk, ls, le, rk, rs, re)
        np.testing.assert_array_equal(
            pc, oracle_counts(lk, ls, le, rk, rs, re).astype(np.int64)
        )
        # skew-aware count (plan_partitions range-splits the hot key)
        got_sk = skew_partitioned_count_mesh(mesh, lk, ls, le, rk, rs, re)
        assert got_sk == want, f"{label}: skew {got_sk} != {want}"
        # materialization: hash-partitioned and all_to_all-shuffled emits
        ob, op = oracle_pairs(lk, ls, le, rk, rs, re)
        want_pairs = sorted(zip(op.tolist(), ob.tolist()))
        b, p = partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        assert sorted(zip(p.tolist(), b.tolist())) == want_pairs, f"{label}: pairs"
        b2, p2 = all_to_all_partitioned_pairs(mesh, lk, ls, le, rk, rs, re)
        assert sorted(zip(p2.tolist(), b2.tolist())) == want_pairs, (
            f"{label}: shuffle pairs"
        )
        results[label] = {"rows": want, "pairs": len(b), "n": n, "m": m}
        print(f"proc {pid}: {label} OK count={want} pairs={len(b)}", flush=True)

    # SQL layer over the SAME global mesh: target_partitions plans
    # Partitioned mode, get_engine_mesh picks up all 8 cross-process
    # devices, and the auto distribution chooser routes the collective
    # paths — the full engine stack on a real 2-process runtime.
    import pyarrow as pa

    from sequila_tpu.session import SessionContext

    rng2 = np.random.default_rng(11)
    nrows = 4000
    ctgs = np.array([f"chr{i}" for i in range(8)])

    def tbl(seed):
        r = np.random.default_rng(seed)
        s = r.integers(0, 50_000, nrows)
        return pa.table(
            {
                "contig": ctgs[r.integers(0, 8, nrows)],
                "pos_start": s,
                "pos_end": s + r.integers(0, 400, nrows),
            }
        )

    ctx = SessionContext()
    ctx.register_table("s1", tbl(1))
    ctx.register_table("s2", tbl(2))
    ctx.sql("SET datafusion.execution.target_partitions = 8")
    q = (
        "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
        "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
    )
    plan = ctx.sql("EXPLAIN " + q).to_pylist()
    plan_text = "\n".join(str(r) for r in plan)
    assert "Partitioned" in plan_text, plan_text
    sql_count = int(ctx.sql(q).column_np(0)[0])
    mat_rows = ctx.sql(q.replace("count(1)", "*")).num_rows
    assert mat_rows == sql_count, (mat_rows, sql_count)
    ctx.sql("SET datafusion.execution.target_partitions = 1")
    single = int(ctx.sql(q).column_np(0)[0])
    assert single == sql_count, (single, sql_count)
    ctx.sql("SET datafusion.execution.target_partitions = 8")
    results["sql_partitioned"] = {"rows": sql_count, "n": nrows, "m": nrows}
    print(f"proc {pid}: SQL Partitioned OK rows={sql_count}", flush=True)

    if pid == 0:
        out = {
            "processes": NPROC,
            "local_devices": LOCAL_DEVICES,
            "mesh": {"part": NPROC, "probe": LOCAL_DEVICES},
            "backend": "cpu+gloo (localhost DCN stand-in)",
            "checks": results,
            "ok": True,
        }
        with open(os.path.join(ROOT, "MULTIHOST.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(f"proc {pid}: MULTIHOST OK", flush=True)


def main() -> int:
    procs = []
    t0 = time.time()
    for pid in range(NPROC):
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(pid)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                cwd=ROOT,
            )
        )
    rc = 0
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=500)
        tail = "\n".join(out.decode(errors="replace").splitlines()[-6:])
        print(f"--- worker {pid} (rc={p.returncode}) ---\n{tail}")
        rc |= p.returncode
    print(f"{'MULTIHOST PASSED' if rc == 0 else 'MULTIHOST FAILED'} in {time.time()-t0:.1f}s")
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        sys.exit(main())
