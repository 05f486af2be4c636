"""Level-decomposed columnar interval index — the device replacement for the
reference's per-chromosome interval trees.

The reference builds, per equi-key (chromosome), one of seven pointer-based
interval structures (COITrees van-Emde-Boas trees, rust-bio AVL trees,
Lapper lists, superintervals branch arrays; reference
interval_join.rs:766-873) and answers each probe row with a per-row
query callback.  None of those shapes map onto batched device kernels.

Two flat-array views are built (lazily, each on first use):

**BITS view** (counting): starts sorted by (key, start) and ends sorted by
(key, end) as two independent arrays.  ``count = #start<=qe − #end<qs``
per key segment (Layer & Quinlan 2012) — two rank ops per probe batch,
exact for all qs <= qe queries regardless of containment depth.

**Level view** (enumeration / nearest / degenerate queries): four flat
int32 arrays (key code, start, end, original row position) sorted by
(level, key, start), where *level* is an AIList-style decomposition with
the invariant:

    within one (level, key) segment sorted by start, the ends are
    NON-DECREASING.

That invariant makes the set of intervals overlapping a query ``[qs, qe]``
a CONTIGUOUS run ``[lb, ub)`` in each level:

    ub = #{ start <= qe }   (starts ascending  -> prefix)
    lb = #{ end   <  qs }   (ends ascending    -> prefix of non-matches)

so exact enumeration is pure arithmetic over contiguous runs — no masking
waste, no trees, no dynamic shapes.

Levels are peeled with a vectorized running-max pass: an interval is kept in
the current level iff its end is >= every earlier end in its key segment;
the rest are peeled to the next level.  The number of levels equals the
maximum "containment depth" of the data (single digits for real genomic
tracks).

All build preparation runs host-side in NumPy (as the reference's index
build runs on CPU); the resulting arrays live in device HBM and are
queried by the kernels in ops/interval_join.py.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# Reserved key code for padding rows: sorts after every real key and never
# equals a probe key.
PAD_KEY = np.int32(2**31 - 1)
PAD_VAL = np.int32(2**31 - 1)


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to a compile-friendly size bucket: powers of two up to 64k,
    then multiples of 64k (keeps padding waste <~6% for large arrays while
    bounding the number of distinct compiled shapes)."""
    b = minimum
    while b < n and b < 65536:
        b *= 2
    if n <= b:
        return b
    return -(-n // 65536) * 65536


def assign_levels(keys: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Peel (key,start)-sorted intervals into monotone-end levels.

    Returns (order, levels): ``order`` sorts the input by (key,start,end);
    ``levels[i]`` is the level of input row ``order[i]`` AFTER applying the
    order (i.e. aligned with the sorted view).
    """
    n = len(keys)
    order = np.lexsort((ends, starts, keys)).astype(np.int64)
    k = keys[order].astype(np.int64)
    e = ends[order].astype(np.int64)
    # Composite (key, end): key dominates, so a running max resets naturally
    # at key-segment boundaries.
    comp_e = (k << 32) | (e + 2**31)
    levels = np.zeros(n, dtype=np.int32)
    remaining = np.arange(n, dtype=np.int64)
    lvl = 0
    while remaining.size:
        ce = comp_e[remaining]
        keep = ce >= np.maximum.accumulate(ce)
        levels[remaining[keep]] = lvl
        remaining = remaining[~keep]
        lvl += 1
    return order, levels


class IntervalIndex:
    """Build-side index with lazily materialized device views.

    Static metadata (python ints/tuples — safe jit-cache keys):
      level_sizes:   real rows per level
      level_pad:     padded rows per level (bucketed)
      level_offsets: start offset of each level in the padded arrays
      n_rows:        total real build rows
    Device arrays:
      levels/keys/starts/ends/pos — the level view, length sum(level_pad),
      sorted by (level, key, start); padding rows carry
      (level, PAD_KEY, PAD_VAL, PAD_VAL, -1).
      bs_keys/bs_starts/be_keys/be_ends — the BITS view, length bucket(n).
    """

    def __init__(self, keys, starts, ends, to_device=jnp.asarray, layout=None):
        self._hk = np.ascontiguousarray(keys, dtype=np.int32)
        self._hs = np.ascontiguousarray(starts, dtype=np.int32)
        self._he = np.ascontiguousarray(ends, dtype=np.int32)
        self._to_device = to_device
        self._layout = tuple(layout) if layout is not None else None
        self.n_rows = len(self._hk)
        self._bits = None
        self._lvl = None
        self._win = None

    # -- BITS view ----------------------------------------------------------
    def _build_bits(self):
        if self._bits is not None:
            return
        # No host sorting: the rank kernel (ops/ranks.rank_lex_sort) co-sorts
        # build and query tuples anyway, so unsorted padded columns suffice.
        n = self.n_rows
        n0 = _bucket(max(n, 1))
        bs_k = np.full(n0, PAD_KEY, np.int32)
        bs_s = np.full(n0, PAD_VAL, np.int32)
        be_e = np.full(n0, PAD_VAL, np.int32)
        if n:
            bs_k[:n] = self._hk
            bs_s[:n] = self._hs
            be_e[:n] = self._he
        d = self._to_device
        k = d(bs_k)
        self._bits = (k, d(bs_s), k, d(be_e))

    @property
    def bs_keys(self):
        self._build_bits()
        return self._bits[0]

    @property
    def bs_starts(self):
        self._build_bits()
        return self._bits[1]

    @property
    def be_keys(self):
        self._build_bits()
        return self._bits[2]

    @property
    def be_ends(self):
        self._build_bits()
        return self._bits[3]

    # -- level view ---------------------------------------------------------
    def _build_levels(self):
        if self._lvl is not None:
            return
        n = self.n_rows
        layout = self._layout
        if n == 0:
            level_pad = layout if layout is not None else (_bucket(1),)
            total = int(sum(level_pad))
            offs = tuple(
                int(x) for x in np.concatenate([[0], np.cumsum(level_pad)[:-1]])
            )
            L = np.zeros(total, dtype=np.int32)
            for lv, (o, p) in enumerate(zip(offs, level_pad)):
                L[o : o + p] = lv
            d = self._to_device
            K0 = np.full(total, PAD_KEY, np.int32)
            V0 = np.full(total, PAD_VAL, np.int32)
            self._lvl = dict(
                level_sizes=tuple(0 for _ in level_pad),
                level_pad=tuple(level_pad),
                level_offsets=offs,
                max_lens=tuple(0 for _ in level_pad),
                levels=d(L),
                keys=d(K0),
                starts=d(V0),
                ends=d(V0),
                pos=d(np.full(total, -1, np.int32)),
                pos_host=np.full(total, -1, np.int32),
            )
            return

        order, levels = assign_levels(self._hk, self._hs, self._he)
        k, s, e = self._hk[order], self._hs[order], self._he[order]
        pos = order.astype(np.int32)

        # Final layout: level-major, then (key, start) (stable sort keeps it).
        final = np.argsort(levels, kind="stable")
        k, s, e, pos, levels = k[final], s[final], e[final], pos[final], levels[final]

        num_levels = int(levels[-1]) + 1
        sizes = np.bincount(levels, minlength=num_levels)
        if layout is not None:
            if len(layout) < num_levels or any(
                layout[i] < sizes[i] for i in range(num_levels)
            ):
                raise ValueError("layout does not cover the data's level sizes")
            num_levels = len(layout)
            sizes = np.concatenate(
                [sizes, np.zeros(num_levels - len(sizes), np.int64)]
            )
            level_sizes = tuple(int(x) for x in sizes)
            level_pad = tuple(layout)
        else:
            level_sizes = tuple(int(x) for x in sizes)
            level_pad = tuple(_bucket(max(int(x), 1)) for x in sizes)
        level_offsets = tuple(
            int(x) for x in np.concatenate([[0], np.cumsum(level_pad)[:-1]])
        )

        total = int(sum(level_pad))
        K = np.full(total, PAD_KEY, np.int32)
        S = np.full(total, PAD_VAL, np.int32)
        E = np.full(total, PAD_VAL, np.int32)
        P = np.full(total, -1, np.int32)
        L = np.zeros(total, np.int32)
        max_lens = []
        row = 0
        for lv in range(num_levels):
            sz = level_sizes[lv]
            off = level_offsets[lv]
            K[off : off + sz] = k[row : row + sz]
            S[off : off + sz] = s[row : row + sz]
            E[off : off + sz] = e[row : row + sz]
            P[off : off + sz] = pos[row : row + sz]
            L[off : off + level_pad[lv]] = lv
            max_lens.append(
                int(np.max(e[row : row + sz] - s[row : row + sz])) if sz else 0
            )
            row += sz

        d = self._to_device
        self._lvl = dict(
            level_sizes=level_sizes,
            level_pad=level_pad,
            level_offsets=level_offsets,
            max_lens=tuple(max_lens),
            levels=d(L), keys=d(K), starts=d(S), ends=d(E), pos=d(P),
            pos_host=P,
        )

    def _lvl_get(self, name):
        self._build_levels()
        return self._lvl[name]

    level_sizes = property(lambda self: self._lvl_get("level_sizes"))
    level_pad = property(lambda self: self._lvl_get("level_pad"))
    level_offsets = property(lambda self: self._lvl_get("level_offsets"))
    max_lens = property(lambda self: self._lvl_get("max_lens"))
    levels = property(lambda self: self._lvl_get("levels"))
    keys = property(lambda self: self._lvl_get("keys"))
    starts = property(lambda self: self._lvl_get("starts"))
    ends = property(lambda self: self._lvl_get("ends"))
    pos = property(lambda self: self._lvl_get("pos"))
    # host copy of the level-view positions (built anyway during index
    # construction): lets emission expand device bounds host-side
    # without copying the full pair list off the device
    pos_host = property(lambda self: self._lvl_get("pos_host"))

    @property
    def num_levels(self) -> int:
        return len(self.level_sizes)

    @property
    def padded_size(self) -> int:
        return int(sum(self.level_pad))

    # -- window view (Lapper-style max-extension kernel) --------------------
    def _build_window(self):
        if getattr(self, "_win", None) is not None:
            return
        n = self.n_rows
        n0 = _bucket(max(n, 1))
        k = np.full(n0, PAD_KEY, np.int32)
        s = np.full(n0, PAD_VAL, np.int32)
        e = np.full(n0, PAD_VAL, np.int32)
        p = np.full(n0, -1, np.int32)
        max_len = 0
        if n:
            order = np.lexsort((self._hs, self._hk))
            k[:n] = self._hk[order]
            s[:n] = self._hs[order]
            e[:n] = self._he[order]
            p[:n] = order.astype(np.int32)
            max_len = int(np.max(self._he.astype(np.int64) - self._hs))
        d = self._to_device
        self._win = (d(k), d(s), d(e), d(p), max_len)

    @property
    def window_view(self):
        """((key,start)-sorted keys/starts/ends/pos device arrays, max_len)."""
        self._build_window()
        return self._win

    @property
    def coverage_view(self):
        """Sorted arrays + int64 prefix sums for the level-free coverage
        decomposition: ((ks, ss dev), (ke, ee dev), prefix_start host,
        prefix_end host) where ss is (key,start)-sorted starts and ee is
        (key,end)-sorted ends."""
        if getattr(self, "_cov", None) is None:
            n = self.n_rows
            n0 = _bucket(max(n, 1))
            ks = np.full(n0, PAD_KEY, np.int32)
            ss = np.full(n0, PAD_VAL, np.int32)
            ke = np.full(n0, PAD_KEY, np.int32)
            ee = np.full(n0, PAD_VAL, np.int32)
            if n:
                o1 = np.lexsort((self._hs, self._hk))
                ks[:n] = self._hk[o1]
                ss[:n] = self._hs[o1]
                o2 = np.lexsort((self._he, self._hk))
                ke[:n] = self._hk[o2]
                ee[:n] = self._he[o2]
            ps = np.concatenate([[0], np.cumsum(np.where(ks == PAD_KEY, 0, ss).astype(np.int64))])
            pe = np.concatenate([[0], np.cumsum(np.where(ke == PAD_KEY, 0, ee).astype(np.int64))])
            d = self._to_device
            self._cov = ((d(ks), d(ss)), (d(ke), d(ee)), ps, pe)
        return self._cov


def build_interval_index(
    keys: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    to_device=jnp.asarray,
    layout: tuple[int, ...] | None = None,
) -> IntervalIndex:
    """Build the (lazy) index from host arrays (int32 keys and i32 bounds).

    ``layout`` optionally forces the padded per-level sizes (must cover the
    data's natural level sizes) — used to give every shard of a partitioned
    build an identical static shape so per-shard indexes stack into one
    [n_shards, N] device array for shard_map execution.
    """
    return IntervalIndex(keys, starts, ends, to_device=to_device, layout=layout)
