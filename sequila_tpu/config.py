"""Session configuration and algorithm selection.

Mirrors the knob surface of the reference engine's ``SequilaConfig``
(reference: sequila/sequila-core/src/session_context.rs:50-136): the options
are settable at runtime via SQL ``SET sequila.<key> = <value>`` and select
between interval-join execution strategies.

The reference's seven algorithms choose among CPU interval-index data
structures (COITrees, rust-bio trees, Lapper, superintervals).  Here all
equality-semantics variants share one index layout (sorted level-decomposed
columnar arrays, see ops/interval_index.py) but select different *query
kernels*; the two semantics-changing variants (nearest, count-overlaps) map
to their own kernels.  The names are kept identical so `SET` statements and
EXPLAIN output from the reference work unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import os


class Algorithm(enum.Enum):
    """Interval-join algorithm knob.

    Same seven names as the reference ``Algorithm`` enum (reference
    session_context.rs:62-119, parsed case-insensitively :86-106).

    Device mapping:

    - ``COITREES`` (default), ``SUPER_INTERVALS``: sort-based rank kernel —
      queries ranked against the index by lexicographic co-sort (XLA's
      device sort), best for large probe batches.
    - ``INTERVAL_TREE``, ``ARRAY_INTERVAL_TREE``: binary-search rank kernel —
      per-query vectorized binary search (gather-based), best for small
      probe batches against large indexes.
    - ``LAPPER``: max-extension window kernel — candidate window
      ``[searchsorted(start, qs - max_len), searchsorted(start, qe)]``
      with an overlap mask, like rust-lapper's layered scan.
    - ``COITREES_NEAREST``: nearest semantics — exactly one output row per
      probe row; first overlap if any, else nearest interval by genomic
      distance, NULL build side when the key is absent (reference
      interval_join.rs:957-990 and tests/integration_test.rs:352-399).
    - ``COITREES_COUNT_OVERLAPS``: count semantics — per-probe-row overlap
      counts without materializing pairs.  (The reference's wiring of this
      variant is internally inconsistent — see SURVEY.md §2 item 9; we
      implement the intended "count per probe row" semantics.)
    """

    COITREES = "Coitrees"
    INTERVAL_TREE = "IntervalTree"
    ARRAY_INTERVAL_TREE = "ArrayIntervalTree"
    LAPPER = "Lapper"
    SUPER_INTERVALS = "SuperIntervals"
    COITREES_NEAREST = "CoitreesNearest"
    COITREES_COUNT_OVERLAPS = "CoitreesCountOverlaps"

    @classmethod
    def parse(cls, s: str) -> "Algorithm":
        key = s.strip().strip("'\"").lower()
        for alg in cls:
            if alg.value.lower() == key:
                return alg
        raise ValueError(f"Can't parse '{s}' as Algorithm")

    def __str__(self) -> str:  # EXPLAIN-compatible display
        return self.value

    @property
    def is_nearest(self) -> bool:
        return self is Algorithm.COITREES_NEAREST

    @property
    def is_count_overlaps(self) -> bool:
        return self is Algorithm.COITREES_COUNT_OVERLAPS


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclasses.dataclass
class SequilaConfig:
    """Runtime-settable engine knobs (SQL prefix ``sequila``).

    ``prefer_interval_join`` / ``interval_join_algorithm`` /
    ``interval_join_low_memory`` mirror the reference defaults
    (session_context.rs:50-56: true / Coitrees / false).

    ``max_output_batch_size`` mirrors env ``SEQUILA_MAX_OUTPUT_BATCH_SIZE``
    (reference interval_join.rs:552-555, default 100_000): the emission cap
    per output chunk in low-memory mode.
    """

    prefer_interval_join: bool = True
    interval_join_algorithm: Algorithm = Algorithm.COITREES
    interval_join_low_memory: bool = False
    # Partitioned-mode distribution (reference PartitionMode::Partitioned
    # declares HashPartitioned on both sides, interval_join.rs:385-404):
    #   auto    — the engine decides per query from the key-weight
    #             histogram: skew-aware range splitting when one key
    #             dominates, device all_to_all shuffle otherwise, host
    #             hash partitioning for shapes the collectives can't
    #             serve (NULL keys, nearest, per-probe counts);
    #   hash    — host-partitioned build/probe (the single-host stand-in);
    #   shuffle — device-side all_to_all exchange (parallel/shuffle.py);
    #   skew    — range-split hot contigs (parallel/skew.py).
    partitioned_distribution: str = "auto"
    # Legacy alias: partitioned_skew=true forces distribution=skew when
    # partitioned_distribution is left at auto.
    partitioned_skew: bool = False
    max_output_batch_size: int = dataclasses.field(
        default_factory=lambda: _env_int("SEQUILA_MAX_OUTPUT_BATCH_SIZE", 100_000)
    )
    # Engine-level knobs (analogs of the `datafusion.*` options the reference
    # README recommends: target_partitions, coalesce_batches, batch_size).
    target_partitions: int = 1
    batch_size: int = 8192

    _BOOL_KEYS = (
        "prefer_interval_join",
        "interval_join_low_memory",
        "partitioned_skew",
    )
    _INT_KEYS = ("max_output_batch_size", "target_partitions", "batch_size")

    def set(self, key: str, value: str) -> None:
        """Apply ``SET sequila.<key> = <value>``; raises on unknown keys."""
        key = key.strip().lower()
        value = str(value).strip().strip("'\"")
        if key in self._BOOL_KEYS:
            setattr(self, key, value.lower() in ("true", "1", "yes", "on"))
        elif key in self._INT_KEYS:
            setattr(self, key, int(value))
        elif key == "interval_join_algorithm":
            self.interval_join_algorithm = Algorithm.parse(value)
        elif key == "partitioned_distribution":
            v = value.lower()
            if v not in ("auto", "hash", "shuffle", "skew"):
                raise ValueError(
                    f"Can't parse '{value}' as partitioned distribution "
                    "(auto|hash|shuffle|skew)"
                )
            self.partitioned_distribution = v
        else:
            raise KeyError(f"unknown config key: sequila.{key}")

    def get(self, key: str):
        key = key.strip().lower()
        if key in self._BOOL_KEYS + self._INT_KEYS + (
            "interval_join_algorithm",
            "partitioned_distribution",
        ):
            return getattr(self, key)
        raise KeyError(f"unknown config key: sequila.{key}")

    def resolved_distribution(self) -> str:
        """The configured distribution with the legacy skew flag folded in."""
        if self.partitioned_distribution == "auto" and self.partitioned_skew:
            return "skew"
        return self.partitioned_distribution

    def copy(self) -> "SequilaConfig":
        return dataclasses.replace(self)
