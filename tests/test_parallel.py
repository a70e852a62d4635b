import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mauvealigner_tpu.core.sml import build_sml
from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.ops import dp, merops
from mauvealigner_tpu.parallel import make_mesh, sharded_pack_sort
from mauvealigner_tpu.parallel.sharded import (
    multichip_pipeline_step,
    sharded_gotoh_scores,
)
from mauvealigner_tpu.seeds import get_seed


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_pack_sort_matches_single_device(make_dna):
    """Range-partitioned distributed SML build: dropping the per-partition
    INVALID tails from the concatenated partition blocks must reproduce the
    single-device globally sorted list exactly (keys AND positions)."""
    seed = get_seed(9, 0)
    seq = make_dna(3000)
    g = Genome.from_string(seq)
    reference = build_sml(g, seed)
    mesh = make_mesh(8)
    codes = merops.pad_codes(g.codes.astype(np.int32), seed.length, pad_to_multiple=1024)
    keys, pos, dropped = sharded_pack_sort(
        jnp.asarray(codes), tuple(int(o) for o in seed.offsets), seed.length, mesh
    )
    assert int(dropped) == 0
    keys = np.asarray(keys)
    pos = np.asarray(pos)
    valid = keys != merops.INVALID_KEY
    assert int(valid.sum()) == len(reference.keys)
    assert np.array_equal(keys[valid], reference.keys)
    assert np.array_equal(pos[valid], reference.positions)


def test_sharded_gotoh_matches_local(rng):
    B, M, N = 8, 16, 16
    pa = np.zeros((B, M, 5), np.float32)
    pb = np.zeros((B, N, 5), np.float32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    seqs = []
    for b in range(B):
        x = rng.integers(0, 4, size=rng.integers(4, M + 1))
        y = rng.integers(0, 4, size=rng.integers(4, N + 1))
        pa[b] = dp.one_hot_profile(x, M)
        pb[b] = dp.one_hot_profile(y, N)
        la[b], lb[b] = len(x), len(y)
        seqs.append((x, y))
    mesh = make_mesh(8)
    scores = np.asarray(
        sharded_gotoh_scores(
            jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(la), jnp.asarray(lb), mesh
        )
    )
    _, expected = dp.align_profiles_batch(pa, pb, la, lb)
    assert np.allclose(scores, expected, atol=1e-3)


def test_multichip_pipeline_step_runs(rng):
    """The dry-run pipeline step must execute the REAL sharded anchor
    search: its candidate tables decode to actual unique MUMs."""
    from mauvealigner_tpu.core.sml import build_mer_list_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.utils import simulate

    mesh = make_mesh(8)
    seed = get_seed(9, 0)
    anc = simulate.random_genome(rng, 1500)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    smls_dev = [build_mer_list_device(g, seed) for g in (anc, der)]
    keys, seq_ids, pos = matchops._concat_device_smls(smls_dev)
    N = int(keys.shape[0])
    D = 8
    C1 = (-(-2 * N // (D * D)) + 7) & ~7
    C2 = (2 * C1 + 7) & ~7
    cap_local = 1 << 10
    B, M = 8, 16
    pa = np.tile(dp.one_hot_profile(np.arange(8) % 4, M)[None], (B, 1, 1))
    la = np.full(B, 8, np.int32)
    tabs, dropped, scores, hom = multichip_pipeline_step(
        mesh, keys, seq_ids, pos, 2, cap_local, C1, C2,
        jnp.asarray(pa), jnp.asarray(pa.copy()),
        jnp.asarray(la), jnp.asarray(la.copy()),
    )
    assert int(np.asarray(dropped).sum()) == 0
    tabs_np = np.asarray(tabs)
    parts = [
        matchops.decode_mum_table(tabs_np[d], 2, cap_local, seed.length)
        for d in range(8)
    ]
    total = sum(len(p) for p in parts)
    assert total > 0  # real anchors came out of the sharded search
    assert np.asarray(scores).shape == (B,)
    assert (np.asarray(scores) > 0).all()
    hom = np.asarray(hom)
    assert hom.shape == (B,) and (hom > 0.5).all()


def _canon_ml(ml):
    rows = np.concatenate([ml.starts, ml.lengths[:, None]], axis=1)
    return set(map(tuple, rows.tolist()))


@pytest.mark.parametrize("n_genomes,size", [(2, 4000), (4, 3000)])
def test_find_multi_mums_sharded_matches_single_device(rng, n_genomes, size):
    from mauvealigner_tpu.core.sml import build_mer_list_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import find_multi_mums_sharded
    from mauvealigner_tpu.utils import simulate

    anc = simulate.random_genome(rng, size)
    genomes = [anc]
    for _ in range(n_genomes - 1):
        d, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
        genomes.append(d)
    genomes[-1] = simulate.apply_inversion(genomes[-1], size // 3, 2 * size // 3)
    seed = get_seed(9, 0)
    smls = [build_mer_list_device(g, seed) for g in genomes]
    single = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
    mesh = make_mesh(8)
    sharded = find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
    assert _canon_ml(single) == _canon_ml(sharded)


@pytest.mark.slow
def test_find_multi_mums_sharded_megabase(rng):
    """The flagship N-way anchor search under a mesh
    on a >= 1 Mbp input, equivalent to single-device."""
    from mauvealigner_tpu.core.sml import build_mer_list_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import find_multi_mums_sharded
    from mauvealigner_tpu.utils import simulate

    anc = simulate.random_genome(rng, 1_000_000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    genomes = [anc, der]
    seed = get_seed(15, 0)
    smls = [build_mer_list_device(g, seed) for g in genomes]
    single = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
    mesh = make_mesh(8)
    sharded = find_multi_mums_sharded(genomes, smls, mesh, seed_length=seed.length)
    assert _canon_ml(single) == _canon_ml(sharded)
    assert len(sharded) > 1000


def test_find_pair_mums_sharded_matches_single_device(rng):
    """Pair-sharded ref-vs-draft MUM search (the config-5 pod axis) must
    reproduce the single-chip per-pair search exactly, across drafts that
    land in different SML length buckets."""
    from mauvealigner_tpu.core.sml import build_sml_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import find_pair_mums_sharded
    from mauvealigner_tpu.utils import simulate

    mesh = make_mesh(8)
    seed = get_seed(9, 0)
    anc = simulate.random_genome(rng, 3000, name="ref")
    drafts = []
    for i in range(5):
        size_factor = 1 if i < 3 else 4  # force two length buckets
        der, _ = simulate.evolve(
            anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001
        )
        seq = der.seq
        if size_factor > 1:
            seq = np.concatenate(
                [seq] + [simulate.random_genome(rng, 9000).seq]
            )
        drafts.append(Genome(seq, name=f"d{i}"))

    got = find_pair_mums_sharded(anc, drafts, seed, mesh)
    assert len(got) == len(drafts)
    for d, ml in zip(drafts, got):
        want = matchops.find_multi_mums_device(
            [anc, d],
            [build_sml_device(anc, seed), build_sml_device(d, seed)],
            seed_length=seed.length,
        )
        assert len(ml) == len(want)
        assert np.array_equal(ml.starts, want.starts)
        assert np.array_equal(ml.lengths, want.lengths)
        assert len(ml) > 0


def test_sort_contigs_sharded_matches_sequential(rng):
    """The pod-sharded draft front half must reorder contigs exactly like
    the sequential MauveAligner + sortContigs flow."""
    from mauvealigner_tpu.genome.sequence import Contig, revcomp_ascii
    from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
    from mauvealigner_tpu.parallel import sort_contigs_sharded
    from mauvealigner_tpu.tools.manipulate import (
        contig_placements_from_lcbs,
        sort_contigs,
    )
    from mauvealigner_tpu.utils import simulate

    mesh = make_mesh(8)
    ref = simulate.random_genome(rng, 6000, name="ref")
    drafts = []
    for i in range(3):
        # 3% divergence produces overlapping MUMs, exercising the
        # eliminate_overlaps + n-way filter steps of the sequential flow
        der, _ = simulate.evolve(ref, rng, sub_rate=0.03, ins_rate=0.001, del_rate=0.001)
        cuts = np.sort(rng.choice(np.arange(500, len(der) - 500), size=3, replace=False))
        edges = np.concatenate([[0], cuts, [len(der)]])
        pieces = []
        for ci, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            chunk = der.seq[a:b]
            if rng.random() < 0.5:
                chunk = revcomp_ascii(chunk)
            pieces.append((f"d{i}_c{ci}", chunk))
        order = rng.permutation(len(pieces))
        contigs, parts, off = [], [], 0
        for idx in order:
            cname, chunk = pieces[idx]
            contigs.append(Contig(cname, len(chunk), off))
            parts.append(chunk)
            off += len(chunk)
        drafts.append(Genome(np.concatenate(parts), contigs=contigs, name=f"d{i}"))

    for weight in (9, None):  # explicit and per-pair-default seed weights
        got = sort_contigs_sharded(ref, drafts, mesh, seed_weight=weight)
        assert len(got) == 3
        for d, (fixed, log) in zip(drafts, got):
            al = MauveAligner(
                AlignerOptions(
                    seed_size=weight or 0, gapped=False, recursive=False,
                    use_sml_cache=False,
                )
            )
            ml = al.find_mums([ref, d])
            assert len(ml.eliminate_overlaps()) != len(ml), "want overlaps"
            _, lcbs = al.determine_lcbs([ref, d], ml)
            placements = contig_placements_from_lcbs(d, lcbs, draft_seq_index=1)
            want_fixed, want_log = sort_contigs(d, placements)
            assert log == want_log
            assert np.array_equal(fixed.seq, want_fixed.seq)
            assert sum(1 for _, s in log if s != 0) > 0


def test_flagship_aligner_under_mesh_matches_single(rng):
    """The full MauveAligner pipeline with its anchor search running over
    the mesh must emit the identical alignment as the single-device run
    (determinism across shardings — SURVEY §7 hard part 5)."""
    import io

    from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
    from mauvealigner_tpu.utils import simulate

    anc = simulate.random_genome(rng, 6000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    der = simulate.apply_inversion(der, 2000, 3500)
    genomes = [anc, der]

    def run(mesh):
        res = MauveAligner(
            AlignerOptions(seed_size=11, use_sml_cache=False, mesh=mesh)
        ).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        return buf.getvalue()

    assert run(None) == run(make_mesh(8))


def test_find_multi_mums_sharded_non_pow2_mesh(rng):
    """Six-device mesh: the hash partition must stay uniform (h % D, not a
    bitmask) and entry rows pad to divide the mesh."""
    from mauvealigner_tpu.core.sml import build_mer_list_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import find_multi_mums_sharded
    from mauvealigner_tpu.utils import simulate

    anc = simulate.random_genome(rng, 3000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    genomes = [anc, der]
    seed = get_seed(9, 0)
    smls = [build_mer_list_device(g, seed) for g in genomes]
    single = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
    sharded = find_multi_mums_sharded(
        genomes, smls, make_mesh(6), seed_length=seed.length
    )
    assert _canon_ml(single) == _canon_ml(sharded)
