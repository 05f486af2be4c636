"""REAL multi-process distributed runtime test.

Spawns tools/multihost_dryrun.py: 2 OS processes x 4 CPU devices joined
via jax.distributed.initialize (Gloo over localhost — the client/
coordinator path a multi-host cluster uses), running hash/collect-left/
shuffle/skew counts, per-probe counts, and both materialization paths
against the brute-force oracle.  This covers what the in-process virtual
mesh cannot: cross-process device_put, collectives over non-addressable
devices, and fetch_global's reshard-to-replicated reads.
"""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_multihost_two_processes():
    env = dict(os.environ, SEQUILA_MH_PORT="29901")
    # the workers set their own JAX_PLATFORMS/XLA_FLAGS; scrub the test
    # session's virtual-mesh settings so they don't leak
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "multihost_dryrun.py")],
        capture_output=True,
        text=True,
        timeout=280,
        cwd=ROOT,
        env=env,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout[-2000:]}"
    assert "MULTIHOST PASSED" in r.stdout
