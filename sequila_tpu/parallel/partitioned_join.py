"""Multi-chip interval join: SPMD shard_map execution over a device mesh.

Two distribution modes mirroring the reference's PartitionMode (reference
interval_join.rs:472-510):

- **collect_left** (reference CollectLeft + OnceAsync): the build-side
  index is replicated to every chip (XLA materializes the broadcast as an
  all-gather over ICI when the build was sharded); probe rows are sharded
  over the whole mesh; per-chip counts are combined with `psum`.

- **partitioned** (reference PartitionMode::Partitioned, required
  distribution HashPartitioned on the equi-keys, interval_join.rs:385-404):
  both sides are hash-partitioned by key code over mesh axis 'part', the
  probe rows additionally row-split over mesh axis 'probe' (so every
  (part, probe) chip owns one build partition x one probe slice — a 2-D
  decomposition).  Per-shard indexes share one static layout so they stack
  into leading-axis device arrays; key-disjointness makes per-shard counts
  sum exactly to the global count (`psum` over both axes).

The host-side hash partitioning here is the single-host stand-in for the
distributed shuffle (a ragged all_to_all on a real pod); the kernel math
is identical either way.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sequila_tpu.ops.interval_index import (
    PAD_KEY,
    PAD_VAL,
    _bucket,
    build_interval_index,
)
from sequila_tpu.ops.interval_join import (
    _bounds_bsearch,
    _bounds_sort,
    counts_from_bounds,
    emit_pairs,
    level_ranks,
    level_ranks_bsearch,
    nearest_from_bounds,
    pair_offsets,
)


def mesh_bounds_strategy() -> str:
    """Per-shard rank strategy for the mesh kernels: 'sort' (lexicographic
    co-sort) or 'bsearch' (vectorized per-level binary search, no sort).

    bsearch is the default on every backend: per genome shard (4.19M
    probes into the 2.35M-row, 12-level index) it took 27.0 ms against
    the co-sort's 204.5 ms on an H100 (400 W limit), and 172 ms against
    3.6 s on the virtual CPU mesh.  SEQUILA_MESH_BOUNDS=sort overrides."""
    import os

    return "sort" if os.environ.get("SEQUILA_MESH_BOUNDS") == "sort" else "bsearch"


def _shard_bounds(lv, ky, st, en, k, s, e, *, num_levels, level_offsets,
                  layout, strategy):
    """Strategy-routed per-shard [lb, ub) bounds (see mesh_bounds_strategy)."""
    if strategy == "bsearch":
        return _bounds_bsearch(
            lv, ky, st, en, k, s, e,
            num_levels=num_levels, level_pad=layout,
            level_offsets=level_offsets,
        )
    return _bounds_sort(
        lv, ky, st, en, k, s, e,
        num_levels=num_levels, level_offsets=level_offsets,
    )


# ---------------------------------------------------------------------------
# Host-side partitioning
# ---------------------------------------------------------------------------


def fetch_global(x) -> np.ndarray:
    """Host value of a possibly cross-process sharded jax.Array.

    Single-process (the common case, incl. the virtual test mesh): a
    plain fetch.  Under jax.distributed with multiple processes, a
    sharded output spans non-addressable devices and cannot be fetched
    directly — reshard to fully-replicated first (one all_gather over
    DCN), then read the local copy.  Validated end to end by
    tools/multihost_dryrun.py (2 processes x 4 devices over Gloo)."""
    if jax.process_count() == 1:
        return np.asarray(x)
    mesh = getattr(getattr(x, "sharding", None), "mesh", None)
    if mesh is None or x.sharding.is_fully_replicated:
        return np.asarray(x)
    rep = jax.jit(
        lambda a: a, out_shardings=NamedSharding(mesh, P())
    )(x)
    return np.asarray(rep)


def _pad_probe(rk, rs, re, cap):
    k = np.full(cap, PAD_KEY, np.int32)
    s = np.full(cap, PAD_VAL, np.int32)
    e = np.full(cap, PAD_VAL - 2, np.int32)  # degenerate: never matches
    k[: len(rk)] = rk
    s[: len(rk)] = rs
    e[: len(rk)] = re
    return k, s, e


def build_partitioned_index(lk, ls, le, npart: int, part_of=None, keys=None):
    """Partition the build side and build per-part indexes with one shared
    static layout.  Returns (stacked arrays dict, static meta).

    Default partitioning is key-hash (`lk % npart`); skew-aware callers
    pass explicit per-row `part_of` assignments and alternative `keys`
    (e.g. shard ids) — rows may then appear in several parts via repeated
    indices in the caller's replica expansion."""
    if part_of is None:
        part_of = lk % npart
    if keys is None:
        keys = lk
    parts = [np.nonzero(part_of == p)[0] for p in range(npart)]

    # First pass: each part's natural level sizes -> shared covering layout.
    from sequila_tpu.ops.interval_index import assign_levels

    nat_sizes = []
    for rows in parts:
        if len(rows) == 0:
            nat_sizes.append([0])
            continue
        _, levels = assign_levels(keys[rows], ls[rows], le[rows])
        nat_sizes.append(np.bincount(levels).tolist())
    num_levels = max(len(s) for s in nat_sizes)
    layout = tuple(
        _bucket(max(1, max((s[i] if i < len(s) else 0) for s in nat_sizes)))
        for i in range(num_levels)
    )

    stacked = {"levels": [], "keys": [], "starts": [], "ends": [], "pos": []}
    for rows in parts:
        idx = build_interval_index(
            keys[rows], ls[rows], le[rows], to_device=np.asarray, layout=layout
        )
        # positions are local to the part; remap to global build rows
        pos = np.asarray(idx.pos)
        remapped = np.where(pos >= 0, rows[np.clip(pos, 0, None)].astype(np.int32), -1) if len(rows) else pos
        stacked["levels"].append(np.asarray(idx.levels))
        stacked["keys"].append(np.asarray(idx.keys))
        stacked["starts"].append(np.asarray(idx.starts))
        stacked["ends"].append(np.asarray(idx.ends))
        stacked["pos"].append(remapped)
    arrays = {name: np.stack(v) for name, v in stacked.items()}
    level_offsets = tuple(
        int(x) for x in np.concatenate([[0], np.cumsum(layout)[:-1]])
    )
    meta = {"num_levels": num_levels, "level_offsets": level_offsets, "layout": layout}
    return arrays, meta


def partition_probe(rk, rs, re, npart: int, nprobe: int, part_of=None, keys=None):
    """Hash-partition probe rows by key over 'part', row-split over 'probe'.

    Returns arrays of shape [npart, nprobe, M] plus the caller-row index of
    each slot ([-1] = padding) for result scattering.  Skew-aware callers
    pass explicit `part_of` and `keys` (shard ids) over replica rows."""
    if part_of is None:
        part_of = rk % npart
    if keys is None:
        keys = rk
    groups = [np.nonzero(part_of == p)[0] for p in range(npart)]
    max_rows = max((len(g) for g in groups), default=1)
    per_chip = _bucket(max(1, -(-max_rows // nprobe)), minimum=8)
    K = np.full((npart, nprobe, per_chip), PAD_KEY, np.int32)
    S = np.full((npart, nprobe, per_chip), PAD_VAL, np.int32)
    E = np.full((npart, nprobe, per_chip), PAD_VAL - 2, np.int32)
    IDX = np.full((npart, nprobe, per_chip), -1, np.int32)
    for p, rows in enumerate(groups):
        for q in range(nprobe):
            sl = rows[q * per_chip : (q + 1) * per_chip]
            K[p, q, : len(sl)] = keys[sl]
            S[p, q, : len(sl)] = rs[sl]
            E[p, q, : len(sl)] = re[sl]
            IDX[p, q, : len(sl)] = sl
    return K, S, E, IDX


# ---------------------------------------------------------------------------
# SPMD kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def partitioned_count_fn(mesh: Mesh, num_levels: int, level_offsets: tuple,
                         layout: tuple, strategy: str):
    """jit-able SPMD count over a ('part','probe') mesh.

    Inputs: stacked index arrays [npart, N] sharded over 'part'; probe
    arrays [npart, nprobe, M] sharded over ('part','probe').  Output: the
    exact global pair count (replicated scalar).
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
        ),
        out_specs=P(),
    )
    def step(levels, keys, starts, ends, qk, qs, qe):
        lv, ky, st, en = levels[0], keys[0], starts[0], ends[0]
        k, s, e = qk[0, 0], qs[0, 0], qe[0, 0]
        lb, ub = _shard_bounds(
            lv, ky, st, en, k, s, e,
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        # 8-row bucket partials psum'd as a vector: int32-safe well past
        # 2^31 total pairs (host finishes the reduction in int64)
        local = counts_from_bounds(lb, ub).reshape(-1, 8).sum(axis=1)
        return jax.lax.psum(local, ("part", "probe"))

    return jax.jit(step)


@functools.lru_cache(maxsize=64)
def collect_left_count_fn(mesh: Mesh, num_levels: int, level_offsets: tuple,
                          layout: tuple, strategy: str):
    """CollectLeft analog: replicated index, fully sharded probe rows."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(),
            P(("part", "probe")), P(("part", "probe")), P(("part", "probe")),
        ),
        out_specs=P(),
    )
    def step(levels, keys, starts, ends, qk, qs, qe):
        lb, ub = _shard_bounds(
            levels, keys, starts, ends, qk, qs, qe,
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        local = counts_from_bounds(lb, ub).reshape(-1, 8).sum(axis=1)
        return jax.lax.psum(local, ("part", "probe"))

    return jax.jit(step)


@functools.lru_cache(maxsize=64)
def shard_totals_fn(mesh: Mesh, num_levels: int, level_offsets: tuple,
                    layout: tuple, strategy: str):
    """Per-shard 8-row-bucket match partials [npart, nprobe, M/8] (emit
    capacity sizing).  Partials stay int32-safe (a bucket is at most
    8 x build-part rows); the host finishes the per-shard sum in int64 —
    a whole-shard device sum would silently wrap at 2^31 pairs."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
        ),
        out_specs=P("part", "probe", None),
    )
    def step(levels, keys, starts, ends, qk, qs, qe):
        lb, ub = _shard_bounds(
            levels[0], keys[0], starts[0], ends[0], qk[0, 0], qs[0, 0], qe[0, 0],
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        return counts_from_bounds(lb, ub).reshape(-1, 8).sum(axis=1)[None, None]

    return jax.jit(step)


def shard_totals(mesh: Mesh, meta, didx, dK, dS, dE) -> np.ndarray:
    """Exact per-shard match totals [npart, nprobe] in int64, guarded by
    the same 2^31 limit as the single-chip emit path (_EMIT_LIMIT): the
    emit kernel's slot/offset arithmetic is int32, so a shard that would
    emit >= 2^31 pairs must be an error, never a silent wrap."""
    from sequila_tpu.errors import ExecutionError
    from sequila_tpu.ops.interval_join import _EMIT_LIMIT

    partials = fetch_global(
        shard_totals_fn(
            mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
            mesh_bounds_strategy(),
        )(*didx, dK, dS, dE)
    ).astype(np.int64)
    totals = partials.sum(axis=-1)
    if totals.size and int(totals.max()) >= _EMIT_LIMIT:
        raise ExecutionError(
            f"a join shard would emit {int(totals.max())} pairs (>= 2^31, "
            "the int32 emit-offset limit); raise target_partitions so no "
            "single (part, probe) shard exceeds it"
        )
    return totals


@functools.lru_cache(maxsize=64)
def partitioned_emit_fn(
    mesh: Mesh, num_levels: int, level_offsets: tuple, capacity: int,
    layout: tuple, strategy: str,
):
    """SPMD exact pair emission: every (part, probe) chip materializes its
    shard's (build_row, probe_row) pairs into a static-capacity buffer —
    the distributed materializing interval join.

    ``base`` ([npart, nprobe] int32) is each shard's continuation offset:
    the chip emits pair slots [base, base + capacity), so a shard whose
    output exceeds the capacity is drained over several calls of the SAME
    compiled kernel (chunked low-memory emission, the mesh analog of the
    reference's capped emission loop, interval_join.rs:1236-1336)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
            P("part", "probe"),
        ),
        out_specs=(P("part", "probe", None), P("part", "probe", None)),
    )
    def step(levels, keys, starts, ends, pos, qk, qs, qe, base):
        lb, ub = _shard_bounds(
            levels[0], keys[0], starts[0], ends[0], qk[0, 0], qs[0, 0], qe[0, 0],
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        offsets, lb_pm = pair_offsets(lb, ub)
        b, p, _valid = emit_pairs(
            offsets, lb_pm, pos[0], base[0, 0],
            capacity=capacity, num_levels=num_levels, level_offsets=level_offsets,
        )
        return b[None, None, :], p[None, None, :]

    return jax.jit(step)


def emit_all_shards(mesh: Mesh, meta, didx, dpos, dK, dS, dE, totals,
                    chunk_limit: int | None = None):
    """Drain every shard's pairs through the fixed-capacity emit kernel.

    Yields (part, chip, build_rows, probe_slots) per shard per chunk with
    invalid slots already stripped.  ``chunk_limit`` caps the per-shard
    buffer (low-memory mode); None sizes it to the largest shard (one
    call).  Exactly ONE kernel compilation either way."""
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    max_total = int(totals.max())
    cap = _bucket(max(1, min(max_total, chunk_limit) if chunk_limit else max_total),
                  minimum=1024)
    emit = partitioned_emit_fn(
        mesh, meta["num_levels"], meta["level_offsets"], cap,
        meta["layout"], mesh_bounds_strategy(),
    )
    # int64 on host; always < 2^31 when passed to the kernel (shard_totals
    # guarantees totals < _EMIT_LIMIT and the loop exits before base >= total)
    base = np.zeros((npart, nprobe), np.int64)
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    while True:
        remaining = np.asarray(totals, np.int64) - base
        if not (remaining > 0).any():
            return
        b, p = emit(*didx, dpos, dK, dS, dE,
                    dev(base.astype(np.int32), P("part", "probe")))
        b = fetch_global(b)
        p = fetch_global(p)
        for part in range(npart):
            for chip in range(nprobe):
                take = int(min(max(remaining[part, chip], 0), cap))
                if take == 0:
                    continue
                valid = b[part, chip] >= 0
                yield part, chip, b[part, chip][valid], p[part, chip][valid]
        base = base + cap


def partitioned_pairs(mesh: Mesh, lk, ls, le, rk, rs, re,
                      chunk_limit: int | None = None):
    """Distributed exact materializing join over the ('part','probe') mesh.

    Two phases (both SPMD): per-shard totals size the static emit
    capacity, then every chip emits its pairs — in fixed-capacity chunks
    when ``chunk_limit`` caps the buffer (low-memory mode); the host maps
    shard-local probe slots back to global rows.  Returns
    (build_rows, probe_rows)."""
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    didx = [
        dev(arrays[n], P("part", None))
        for n in ("levels", "keys", "starts", "ends")
    ]
    dpos = dev(arrays["pos"], P("part", None))
    dK = dev(K, P("part", "probe", None))
    dS = dev(S, P("part", "probe", None))
    dE = dev(E, P("part", "probe", None))

    totals = shard_totals(mesh, meta, didx, dK, dS, dE)
    out_b, out_p = [], []
    for part, chip, b_valid, p_valid in emit_all_shards(
        mesh, meta, didx, dpos, dK, dS, dE, totals, chunk_limit
    ):
        out_b.append(b_valid)
        out_p.append(IDX[part, chip][p_valid])
    if not out_b:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    return np.concatenate(out_b), np.concatenate(out_p)


@functools.lru_cache(maxsize=64)
def partitioned_nearest_fn(
    mesh: Mesh, num_levels: int, level_offsets: tuple, layout: tuple,
    strategy: str,
):
    """SPMD nearest: per-shard nearest (first overlap, else min genomic
    distance, else -1) — the mesh analog of the reference's
    CoitreesNearest semantics (interval_join.rs:909-1020).  Exact when
    each probe's full candidate set lives in its shard: trivially true
    under hash partitioning (whole key per part), and true under skew
    range-splitting IF the caller replicated the canonical boundary
    fringe rows (parallel/skew.py:skew_partitioned_nearest)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
        ),
        out_specs=P("part", "probe", None),
    )
    def step(levels, keys, starts, ends, pos, qk, qs, qe):
        lv, ky, st, en = levels[0], keys[0], starts[0], ends[0]
        k, s, e = qk[0, 0], qs[0, 0], qe[0, 0]
        lb, ub = _shard_bounds(
            lv, ky, st, en, k, s, e,
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        res = nearest_from_bounds(
            lb, ub, lv, ky, st, en, pos[0], k, s, e,
            level_offsets=level_offsets, level_pad=layout,
        )
        return res[None, None, :]

    return jax.jit(step)


def partitioned_nearest(mesh: Mesh, lk, ls, le, rk, rs, re) -> np.ndarray:
    """Global nearest build row per probe row (-1 = key absent) over the
    ('part','probe') mesh."""
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    didx = [
        dev(arrays[n], P("part", None))
        for n in ("levels", "keys", "starts", "ends")
    ]
    dpos = dev(arrays["pos"], P("part", None))
    fn = partitioned_nearest_fn(
        mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
        mesh_bounds_strategy(),
    )
    res = fetch_global(fn(
        *didx, dpos,
        dev(K, P("part", "probe", None)),
        dev(S, P("part", "probe", None)),
        dev(E, P("part", "probe", None)),
    ))
    out = np.full(len(rk), -1, np.int64)
    slot_rows = IDX.reshape(-1)
    slot_res = res.reshape(-1)
    real = slot_rows >= 0
    out[slot_rows[real]] = slot_res[real]
    return out


@functools.lru_cache(maxsize=64)
def partitioned_probe_counts_fn(mesh: Mesh, num_levels: int,
                                level_offsets: tuple, layout: tuple,
                                strategy: str):
    """Per-probe-slot overlap counts [npart, nprobe, M] (CountOverlaps /
    grouped-count semantics on the mesh; exact for degenerate probes and
    inverted builds — the level path, not BITS)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
        ),
        out_specs=P("part", "probe", None),
    )
    def step(levels, keys, starts, ends, qk, qs, qe):
        lb, ub = _shard_bounds(
            levels[0], keys[0], starts[0], ends[0], qk[0, 0], qs[0, 0], qe[0, 0],
            num_levels=num_levels, level_offsets=level_offsets,
            layout=layout, strategy=strategy,
        )
        return counts_from_bounds(lb, ub)[None, None, :]

    return jax.jit(step)


def partitioned_probe_counts(mesh: Mesh, lk, ls, le, rk, rs, re) -> np.ndarray:
    """Exact per-probe-row overlap counts over the mesh (int64 [m])."""
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    didx = [
        dev(arrays[n], P("part", None))
        for n in ("levels", "keys", "starts", "ends")
    ]
    fn = partitioned_probe_counts_fn(
        mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
        mesh_bounds_strategy(),
    )
    res = fetch_global(fn(
        *didx,
        dev(K, P("part", "probe", None)),
        dev(S, P("part", "probe", None)),
        dev(E, P("part", "probe", None)),
    )).astype(np.int64)
    out = np.zeros(len(rk), np.int64)
    slot_rows = IDX.reshape(-1)
    slot_counts = res.reshape(-1)
    real = slot_rows >= 0
    out[slot_rows[real]] = slot_counts[real]
    return out


@functools.lru_cache(maxsize=64)
def partitioned_coverage_ranks_fn(mesh: Mesh, num_levels: int,
                                  level_offsets: tuple, layout: tuple,
                                  strategy: str):
    """Per-shard level-rank matrices for coverage: the device does the
    O((n+m) log) ranking work; the host finishes with int64 prefix-sum
    arithmetic (device int64 is unavailable — x64 stays off)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("part", None), P("part", None), P("part", None), P("part", None),
            P("part", "probe", None), P("part", "probe", None), P("part", "probe", None),
        ),
        out_specs=(
            P("part", "probe", None, None), P("part", "probe", None, None),
            P("part", "probe", None, None), P("part", "probe", None, None),
        ),
    )
    def step(levels, keys, starts, ends, qk, qs, qe):
        kw = dict(num_levels=num_levels, level_offsets=level_offsets)
        if strategy == "bsearch":
            rank = functools.partial(level_ranks_bsearch, level_pad=layout, **kw)
        else:
            rank = functools.partial(level_ranks, **kw)
        lv, ky, st, en = levels[0], keys[0], starts[0], ends[0]
        k, s, e = qk[0, 0], qs[0, 0], qe[0, 0]
        lb = rank(lv, ky, en, k, s, side="left")
        ub = rank(lv, ky, st, k, e, side="right")
        t = rank(lv, ky, en, k, e, side="right")
        r = rank(lv, ky, st, k, s, side="left")
        return lb[None, None], ub[None, None], t[None, None], r[None, None]

    return jax.jit(step)


def partitioned_coverage(mesh: Mesh, lk, ls, le, rk, rs, re):
    """Per-probe (count, covered_bases) on the mesh — superintervals
    coverage semantics (superintervals.rs:802-822), exact for every query
    shape.  Returns int64 arrays ([m], [m])."""
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    didx = [
        dev(arrays[n], P("part", None))
        for n in ("levels", "keys", "starts", "ends")
    ]
    fn = partitioned_coverage_ranks_fn(
        mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
        mesh_bounds_strategy(),
    )
    LB, UB, T, R = (fetch_global(x).astype(np.int64) for x in fn(
        *didx,
        dev(K, P("part", "probe", None)),
        dev(S, P("part", "probe", None)),
        dev(E, P("part", "probe", None)),
    ))
    from sequila_tpu.ops.genomic import coverage_finish

    out_c = np.zeros(len(rk), np.int64)
    out_b = np.zeros(len(rk), np.int64)
    for part in range(npart):
        # per-part prefix sums over the padded level arrays (padding rows
        # are zeroed; rank windows never cover them anyway)
        real = arrays["pos"][part] >= 0
        ps = np.concatenate([[0], np.cumsum(
            np.where(real, arrays["starts"][part], 0).astype(np.int64))])
        pe = np.concatenate([[0], np.cumsum(
            np.where(real, arrays["ends"][part], 0).astype(np.int64))])
        for chip in range(nprobe):
            rows = IDX[part, chip]
            keep = rows >= 0
            if not keep.any():
                continue
            counts, total = coverage_finish(
                LB[part, chip], UB[part, chip], T[part, chip], R[part, chip],
                meta["level_offsets"], ps, pe,
                S[part, chip].astype(np.int64), E[part, chip].astype(np.int64),
            )
            out_c[rows[keep]] = counts[keep]
            out_b[rows[keep]] = total[keep]
    return out_c, out_b


# ---------------------------------------------------------------------------
# High-level entry points
# ---------------------------------------------------------------------------


def partitioned_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    npart = mesh.shape["part"]
    nprobe = mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, _ = partition_probe(rk, rs, re, npart, nprobe)
    fn = partitioned_count_fn(
        mesh, meta["num_levels"], meta["level_offsets"], meta["layout"],
        mesh_bounds_strategy(),
    )
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    partials = fn(
        dev(arrays["levels"], P("part", None)),
        dev(arrays["keys"], P("part", None)),
        dev(arrays["starts"], P("part", None)),
        dev(arrays["ends"], P("part", None)),
        dev(K, P("part", "probe", None)),
        dev(S, P("part", "probe", None)),
        dev(E, P("part", "probe", None)),
    )
    return int(np.asarray(partials).astype(np.int64).sum())


def collect_left_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    n_chips = mesh.shape["part"] * mesh.shape["probe"]
    index = build_interval_index(lk, ls, le, to_device=np.asarray)
    cap = _bucket(max(1, -(-len(rk) // n_chips)), minimum=8) * n_chips
    K, S, E = _pad_probe(rk, rs, re, cap)
    fn = collect_left_count_fn(
        mesh, index.num_levels, index.level_offsets, index.level_pad,
        mesh_bounds_strategy(),
    )
    dev = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    partials = fn(
        dev(np.asarray(index.levels), P()),
        dev(np.asarray(index.keys), P()),
        dev(np.asarray(index.starts), P()),
        dev(np.asarray(index.ends), P()),
        dev(K, P(("part", "probe"))),
        dev(S, P(("part", "probe"))),
        dev(E, P(("part", "probe"))),
    )
    return int(np.asarray(partials).astype(np.int64).sum())
