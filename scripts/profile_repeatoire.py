"""cProfile the repeatoire config-4 host passes on the current platform.

Runs config 4's exact workload twice (cold + warm) and prints the warm run's
top host functions — the harness for the host build loop (tandem checks,
pop-time subsumption, flank-job assembly).

Usage: python scripts/profile_repeatoire.py [top_n]
"""

import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    top_n = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    from mauvealigner_tpu.genome.sequence import Genome
    from mauvealigner_tpu.models.repeatoire import Repeatoire, RepeatoireOptions
    from mauvealigner_tpu.utils import simulate, timing

    rng = np.random.default_rng(37)
    parts = [simulate.random_genome(rng, 30_000).seq]
    unit1 = simulate.random_genome(rng, 600).seq
    unit2 = simulate.random_genome(rng, 300).seq
    for i in range(8):
        parts.append(unit1.copy())
        parts.append(simulate.random_genome(rng, 20_000).seq)
        if i % 2 == 0:
            parts.append(unit2.copy())
            parts.append(simulate.random_genome(rng, 10_000).seq)
    g = Genome(np.concatenate(parts), name="repeats")

    t0 = time.time()
    fams = Repeatoire(RepeatoireOptions()).find_repeats(g)
    print(f"cold {time.time() - t0:.2f}s, {len(fams)} families", flush=True)

    timing.GLOBAL.reset()
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    fams = Repeatoire(RepeatoireOptions()).find_repeats(g)
    pr.disable()
    print(f"warm {time.time() - t0:.2f}s, {len(fams)} families", flush=True)
    print(timing.GLOBAL.report(), flush=True)
    pstats.Stats(pr).sort_stats("tottime").print_stats(top_n)


if __name__ == "__main__":
    main()
