"""NumPy reference implementations (test oracles) of the interval kernels.

Brute-force O(n*m) semantics transcribed from the reference engine's
contracts: end-inclusive i32 overlap (interval_join.rs get(), :957-1020),
nearest (:909-990), counts.  Used by the test-suite as ground truth for the
device kernels, mirroring how the reference uses stock HashJoin/NLJ output as
its cross-algorithm oracle (tests/integration_test.rs).
"""

from __future__ import annotations

import numpy as np


def oracle_pairs(bk, bs, be, qk, qs, qe):
    """All (build_row, probe_row) pairs with key equality and overlap."""
    out_b, out_p = [], []
    for i in range(len(qk)):
        mask = (bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i])
        rows = np.nonzero(mask)[0]
        out_b.extend(rows.tolist())
        out_p.extend([i] * len(rows))
    return np.asarray(out_b, np.int32), np.asarray(out_p, np.int32)


def oracle_counts(bk, bs, be, qk, qs, qe):
    counts = np.zeros(len(qk), np.int32)
    for i in range(len(qk)):
        counts[i] = np.sum((bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i]))
    return counts


def oracle_nearest(bk, bs, be, qk, qs, qe):
    """First-overlap-else-true-nearest; -1 when the key is absent.

    Distances per the reference: right candidate `start - qe`, left
    candidate `qs - end`; ties prefer the left (upstream) candidate.
    Overlap pick is 'any overlap' (the reference returns an arbitrary tree
    visit; row-count semantics are what's contractual).
    """
    out = np.full(len(qk), -1, np.int64)
    for i in range(len(qk)):
        seg = np.nonzero(bk == qk[i])[0]
        if len(seg) == 0:
            continue
        overlap = seg[(bs[seg] <= qe[i]) & (be[seg] >= qs[i])]
        if len(overlap):
            out[i] = overlap[0]
            continue
        left = seg[be[seg] < qs[i]]
        right = seg[bs[seg] > qe[i]]
        best_d, best_row = None, -1
        if len(left):
            j = left[np.argmax(be[left])]
            best_d, best_row = qs[i] - be[j], j
        if len(right):
            j = right[np.argmin(bs[right])]
            d = bs[j] - qe[i]
            if best_d is None or d < best_d:
                best_d, best_row = d, j
        out[i] = best_row
    return out


def oracle_nearest_canonical(bk, bs, be, qk, qs, qe):
    """Nearest with the engine's CANONICAL tie-breaking — exact row ids.

    Matches nearest_from_bounds / HostIntervalIndex.nearest / the native
    index bit-for-bit: overlap pick = lexicographic (start, end, row)
    minimum among overlapping rows; upstream tie = (end, start, row)
    maximum; downstream tie = (start, end, row) minimum; equal distances
    prefer upstream (reference interval_join.rs:909-956 distance rules).
    """
    bs64 = np.asarray(bs, np.int64)
    be64 = np.asarray(be, np.int64)
    rows64 = np.arange(len(bs64), dtype=np.int64)
    out = np.full(len(qk), -1, np.int64)
    for i in range(len(qk)):
        seg = np.nonzero(bk == qk[i])[0]
        if len(seg) == 0:
            continue
        overlap = seg[(bs64[seg] <= qe[i]) & (be64[seg] >= qs[i])]
        if len(overlap):
            trip = sorted(zip(bs64[overlap], be64[overlap], rows64[overlap]))
            out[i] = trip[0][2]
            continue
        left = seg[be64[seg] < qs[i]]
        right = seg[bs64[seg] > qe[i]]
        best_d, best_row = None, -1
        if len(left):
            trip = sorted(zip(be64[left], bs64[left], rows64[left]))
            j = trip[-1][2]
            best_d, best_row = qs[i] - be64[j], j
        if len(right):
            trip = sorted(zip(bs64[right], be64[right], rows64[right]))
            j = trip[0][2]
            d = bs64[j] - qe[i]
            if best_d is None or d < best_d:
                best_d, best_row = d, j
        out[i] = best_row
    return out
