"""mauvealigner_tpu: an accelerator-native whole-genome multiple alignment
framework.

A ground-up redesign of the Mauve genome-alignment system (reference:
koadman/mauveAligner v1.2.1 + its libMems/libGenome/libMUSCLE core) for
JAX accelerators.  Compute-heavy phases (spaced-mer sorting, multi-MUM
enumeration, gapped affine DP, homology-HMM scans) run on device via
JAX/XLA; orchestration, combinatorial LCB logic, trees and serialization
run on host.

Layer map (mirrors SURVEY.md §1):
  L0 genome/    sequence model + FASTA/GenBank/raw I/O
  L1 seeds.py   spaced-seed registry;  core/sml.py sorted mer lists
  L2 ops/matchops.py  multi-MUM enumeration
  L3 core/      match / interval / gapped-alignment data model, XMFA
  L4 ops/dp.py  banded affine-gap DP (replaces libMUSCLE subprocess)
  L5 models/    Aligner / ProgressiveAligner / Repeatoire pipelines
  L6 analysis/  islands, backbone HMM, scoring, distance matrices
  L7 tools/     command-line applications
  L8 analysis/tree.py  phylogenetic utilities
"""

import os

import jax

# Genome coordinates and packed spaced-seed mers need 64-bit integers
# (seed weight w -> 2w+1 key bits; w can exceed 15).  Enable x64 before any
# array is created.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the pipeline compiles a bounded family of
# bucketed kernel shapes, and caching them across processes keeps start-up
# fast.  JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is
# left alone; otherwise the cache lives at one fixed path in the checkout
# (the path is part of the cache key, so it must not move).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".jax_cache")),
    )

__version__ = "0.1.0"

DEFAULT_RANDOM_SEED = 37  # reference: SetTwisterSeed(37), progressiveMauve.cpp:355
