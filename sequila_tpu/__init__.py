"""sequila-tpu: an accelerator-native vectorized query-execution engine for
genomic interval queries.

A from-scratch JAX/XLA re-design of the capabilities of
biodatageeks/sequila-native (an Apache DataFusion extension written in Rust):
a SQL/DataFrame engine whose flagship operator is a range-overlap *interval
join*, plus nearest, count-overlaps, coverage/pileup, merge, complement and
closest operators over columnar genomic interval tables.

Where the reference builds per-chromosome pointer-based interval trees
(COITrees / Lapper / superintervals; see reference
sequila/sequila-core/src/physical_planner/joins/interval_join.rs) and probes
them row by row on the CPU, this engine keeps intervals as flat sorted
columnar arrays decomposed into monotone "levels" so that every overlap query
becomes a pair of vectorized rank computations with contiguous match runs —
a formulation that maps directly onto GPU sort/scan/gather hardware and
scales over device meshes with XLA collectives.
"""

from sequila_tpu._jaxcache import setup_jax_compilation_cache
from sequila_tpu._malloc import tune_malloc
from sequila_tpu.config import Algorithm, SequilaConfig

setup_jax_compilation_cache()
tune_malloc()

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy import: keeps `import sequila_tpu.ops` cheap for kernel-only use.
    if name == "SessionContext":
        from sequila_tpu.session import SessionContext

        return SessionContext
    if name == "IntervalMap":
        # the superintervals-wheel API surface (reference intervalmap.pyx)
        from sequila_tpu.intervalmap import IntervalMap

        return IntervalMap
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Algorithm",
    "IntervalMap",
    "SequilaConfig",
    "SessionContext",
    "__version__",
]
