"""Distribution layer: mesh construction + sharded kernels.

Replaces the reference's distribution mechanisms (SURVEY.md
§2 parallelism checklist): the file-based map-reduce over seed space
(--match-log/--offset-log/--merge-match-log, src/mauveAligner.cpp:533-589),
the per-LCB task split (--realign-lcb, src/mauveAligner.cpp:723-744) and the
missing MPI variant are all subsumed by SPMD sharding over a device mesh:

  * K1/K2: genome replicated, *seed space* sharded — each device packs and
    sorts its block of window positions; the flagship N-way anchor search
    runs as two all-to-all phases (mer hash, then signature hash) with
    local-exact grouping and run merging;
  * K3: inter-anchor DP tiles are batch-sharded across devices (the
    analog of --realign-lcb task parallelism);
  * multi-process (DCN): the same shard_map kernels over a global mesh via
    parallel.multihost (jax.distributed; the mpiMauveAligner replacement).

Imports are lazy (PEP 562): multihost.init_multihost must be callable
before anything initializes the XLA backend, and importing the kernel
modules eagerly would.
"""

__all__ = [
    "find_multi_mums_sharded",
    "find_pair_mums_sharded",
    "sharded_mum_candidate_tables",
    "sort_contigs_sharded",
    "make_mesh",
    "sharded_pack_sort",
    "sharded_pair_mum_tables",
    "multihost",
    "context",
    "active_mesh",
    "use_mesh",
    "shard_batched_call",
]


def __getattr__(name):
    import importlib

    if name == "multihost":
        return importlib.import_module("mauvealigner_tpu.parallel.multihost")
    if name == "context":
        return importlib.import_module("mauvealigner_tpu.parallel.context")
    if name in ("active_mesh", "use_mesh", "shard_batched_call"):
        ctx = importlib.import_module("mauvealigner_tpu.parallel.context")
        return getattr(ctx, name)
    if name in __all__:
        sharded = importlib.import_module("mauvealigner_tpu.parallel.sharded")
        return getattr(sharded, name)
    raise AttributeError(name)
