"""Device-mesh construction for the engine's partition parallelism.

The reference parallelizes with DataFusion partitions on a tokio thread
pool (`target_partitions`), with two distribution modes for the interval
join: CollectLeft (single shared build) and Partitioned (hash-partitioned
both sides) — reference interval_join.rs:258-321,385-404.  The device-mesh
analogs (SURVEY.md §2 parallelism table):

- mesh axis 'part': contig-hash partition of the build side (the
  Partitioned mode analog; exchange = all_to_all-style host/device shuffle);
- mesh axis 'probe': row-parallel split of the probe stream within each
  partition (the analog of multiple probe partitions sharing one build via
  OnceAsync, plus psum for count aggregates).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, part: int | None = None) -> Mesh:
    """A 2-D ('part', 'probe') mesh over the available devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if part is None:
        # squarest split with part | n
        part = 1
        for p in range(int(np.sqrt(n)), 0, -1):
            if n % p == 0:
                part = p
                break
    probe = n // part
    return Mesh(np.array(devs[: part * probe]).reshape(part, probe), ("part", "probe"))
