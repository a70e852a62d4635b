"""Sharded device kernels over a jax.sharding.Mesh.

Strategy (SURVEY.md §5.8 / §7 step 8): genomes are replicated per host;
the *work* is sharded —

  * `sharded_pack_sort`: the seed/window space of a genome is split into
    contiguous blocks (with a pattern-length halo); each device packs and
    locally sorts its block; the shards are then merged by a final
    all-gathered sort.  This is the distributed SML build.
  * `sharded_gotoh_scores`: a batch of DP problems sharded over the batch
    dimension (data parallelism over inter-anchor regions / LCBs).
  * `multichip_pipeline_step`: one full anchoring+DP step under a single
    jit over the mesh — the driver's multi-chip dry-run target.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mauvealigner_tpu.ops import dp as dp_ops
from mauvealigner_tpu.ops import merops

AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (AXIS,))


def _dispatch(part: jnp.ndarray, D: int, C: int, arrays_with_fill):
    """Scatter entries into [D, C]-slot send buffers by destination `part`
    (== D drops the entry).  Returns ([D*C] buffers, dropped count) — the
    per-destination slot assignment is order-stable (sorted by arrival
    index), so results are deterministic."""
    n = part.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    part_s, src = jax.lax.sort((part, iota), num_keys=2)
    newg = jnp.concatenate(
        [jnp.ones(1, bool), part_s[1:] != part_s[:-1]]
    )
    gstart = jax.lax.cummax(jnp.where(newg, iota, 0))
    slot = iota - gstart
    keep = (part_s < D) & (slot < C)
    addr = jnp.where(keep, part_s * C + slot, D * C)
    outs = []
    for arr, fill in arrays_with_fill:
        buf = jnp.full(D * C, fill, arr.dtype).at[addr].set(
            arr[src], mode="drop"
        )
        outs.append(buf)
    dropped = jnp.sum((part < D).astype(jnp.int32)) - jnp.sum(keep.astype(jnp.int32))
    return outs, dropped


def _canonical_splitters(weight: int, D: int) -> np.ndarray:
    """Range splitters over canonical-mer KEY space that balance load.

    Canonical mers are min(fwd, rc) of ~uniform 2w-bit values, so their CDF
    is P(c < q*4^w) = 1-(1-q)^2; equal-mass boundaries are
    q_i = 1 - sqrt(1 - i/D).  Keys carry the strand bit below the mer, so
    splitters shift left one bit."""
    i = np.arange(D, dtype=np.float64)
    q = 1.0 - np.sqrt(1.0 - i / D)
    mer_space = float(4 ** weight)
    return (np.floor(q * mer_space).astype(np.int64) << 1)


def sharded_pack_sort(
    codes: jnp.ndarray,
    offsets: Tuple[int, ...],
    pattern_len: int,
    mesh: Mesh,
    capacity_factor: float = 1.6,
):
    """Distributed SML build: block-shard the window space, pack locally,
    range-partition by canonical-key value with an all-to-all, and sort each
    partition locally.  No replicated global re-sort: each device touches
    ~(capacity_factor/D) of the entries end to end.

    Returns (keys int64[D*C], pos int32[D*C], dropped int32): partition d
    occupies slots [d*C, (d+1)*C), sorted ascending with INVALID padding at
    its tail; concatenation is therefore globally ordered after dropping
    INVALID entries.  dropped > 0 means a partition overflowed its capacity
    (retry with a larger factor).
    """
    n_dev = mesh.devices.size
    n_pos = codes.shape[0] - pattern_len + 1
    block = -(-n_pos // n_dev)  # ceil
    halo = pattern_len - 1
    C = int(np.ceil(block * capacity_factor / n_dev)) * n_dev
    splitters = jnp.asarray(
        _canonical_splitters(len(offsets), n_dev), jnp.int64
    )

    def local(codes_rep):
        d = jax.lax.axis_index(AXIS)
        start = d * block
        # each device packs windows [start, start+block) using codes with halo
        chunk = jax.lax.dynamic_slice(codes_rep, (start,), (block + halo,))
        keys = merops.pack_canonical_mers(chunk, offsets, pattern_len)
        pos = start + jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0).reshape(block)
        valid = keys != merops.INVALID_KEY
        part = (
            jnp.searchsorted(splitters, keys, side="right").astype(jnp.int32) - 1
        )
        part = jnp.where(valid, jnp.clip(part, 0, n_dev - 1), jnp.int32(n_dev))
        (sk, sp), dropped = _dispatch(
            part, n_dev, C // n_dev,
            [(keys, merops.INVALID_KEY), (pos, np.int32(0))],
        )
        rk = jax.lax.all_to_all(sk.reshape(n_dev, C // n_dev), AXIS, 0, 0)
        rp = jax.lax.all_to_all(sp.reshape(n_dev, C // n_dev), AXIS, 0, 0)
        keys_s, pos_s = merops.sort_key_pos(rk.reshape(-1), rp.reshape(-1))
        return keys_s[None], pos_s[None], dropped.reshape(1)

    # pad codes so every device's dynamic_slice is in range
    need = block * n_dev + halo
    if codes.shape[0] < need:
        codes = jnp.concatenate(
            [codes, jnp.full(need - codes.shape[0], 4, codes.dtype)]
        )
    keys_sh, pos_sh, dropped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,
    )(codes)
    return keys_sh.reshape(-1), pos_sh.reshape(-1), jnp.sum(dropped)


def sharded_mum_candidate_tables(
    keys: jnp.ndarray,       # int64[N] canonical keys (strand LSB), N % D == 0
    seq_ids: jnp.ndarray,    # int32[N]
    positions: jnp.ndarray,  # int32[N]
    n_seqs: int,
    cap_local: int,          # candidate-run capacity PER DEVICE
    C1: int,                 # phase-1 per-(src,dst) slot capacity
    C2: int,                 # phase-2 per-(src,dst) slot capacity
    mesh: Mesh,
    min_multi: int = 2,
):
    """The flagship N-way anchor search under a mesh: unique multi-MUM
    candidate runs with NO replicated re-sort — each device sorts only its
    partition (~N/D entries per phase).

    Two all-to-all phases (the reference analog is the offset-partitioned
    match search + merge of src/mauveAligner.cpp:533-589, re-imagined as
    collectives):

      1. entries route to hash(mer): seed grouping, per-genome uniqueness,
         reference selection and the 64-bit group signature are local-exact
         because every occurrence of a mer lands on one device;
      2. kept entries route to hash(signature): all windows of one diagonal
         run share the signature by construction, so run merging is
         local-exact on the receiving device.

    Returns (tables int32[D, cap_local+1, n_seqs+2] — device d's packed
    candidate table over its signature partition — and dropped int32[D],
    the per-device count of entries lost to slot-capacity overflow; any
    nonzero count means the caller must retry with larger capacities).
    """
    from mauvealigner_tpu.ops import matchops

    D = mesh.devices.size
    N = keys.shape[0]
    assert N % D == 0
    mask = jnp.ones(n_seqs, jnp.int32)

    def local(k, s, p):
        # --- phase 1: route whole mers to hash(mer) ---
        mer = k >> 1
        valid = k != merops.INVALID_KEY
        # jnp.mod (numpy semantics: non-negative for a positive divisor)
        # keeps the partition uniform for ANY mesh size; & (D-1) would leave
        # devices empty on non-power-of-two meshes
        h1 = matchops._mix64(mer + 3, matchops._MIX_C2)
        part1 = jnp.where(
            valid, (h1 % jnp.int64(D)).astype(jnp.int32), jnp.int32(D)
        )
        sp64 = (s.astype(jnp.int64) << 32) | p.astype(jnp.int64)
        (sk, ssp), drop1 = _dispatch(
            part1, D, C1, [(k, merops.INVALID_KEY), (sp64, np.int64(0))]
        )
        rk = jax.lax.all_to_all(sk.reshape(D, C1), AXIS, 0, 0).reshape(-1)
        rsp = jax.lax.all_to_all(ssp.reshape(D, C1), AXIS, 0, 0).reshape(-1)
        rs = (rsp >> 32).astype(jnp.int32)
        rp = (rsp & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
        # --- local grouping/signature over this device's mer partition ---
        (_, kept, _, rep_sig, seq2, _, spos2, ref_pos) = matchops._sig_phase(
            rk, rs, rp, mask, n_seqs, min_multi, False
        )
        # --- phase 2: route kept entries to hash(signature) ---
        h2 = matchops._mix64(rep_sig + 5, matchops._MIX_C1)
        part2 = jnp.where(
            kept, (h2 % jnp.int64(D)).astype(jnp.int32), jnp.int32(D)
        )
        (sig_b, p0_b, spos_b, seq_b), drop2 = _dispatch(
            part2, D, C2,
            [(rep_sig, np.int64(0)), (ref_pos, np.int32(0)),
             (spos2, np.int32(0)), (seq2, np.int32(-1))],
        )
        sig_r = jax.lax.all_to_all(sig_b.reshape(D, C2), AXIS, 0, 0).reshape(-1)
        p0_r = jax.lax.all_to_all(p0_b.reshape(D, C2), AXIS, 0, 0).reshape(-1)
        spos_r = jax.lax.all_to_all(spos_b.reshape(D, C2), AXIS, 0, 0).reshape(-1)
        seq_r = jax.lax.all_to_all(seq_b.reshape(D, C2), AXIS, 0, 0).reshape(-1)
        # --- local run merging over this device's signature partition ---
        packed = matchops.mum_runs_from_sig_entries(
            sig_r, p0_r, seq_r, spos_r, n_seqs, cap_local
        )
        return packed[None], (drop1 + drop2).astype(jnp.int32).reshape(1)

    spec = P(AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )(keys, seq_ids, positions)


def find_multi_mums_sharded(
    genomes,
    smls_dev,
    mesh: Mesh,
    min_multi: int = 2,
    nway: bool = False,
    extend: bool = True,
    seed_length: int = 0,
) -> "MatchList":
    """Mesh-sharded drop-in for matchops.find_multi_mums_device.

    Equivalence note: hash partitioning by signature keeps diagonal runs
    whole, but a run whose windows span a group-signature CHANGE (the same
    base match seen through different uniqueness context) can fragment
    exactly as on one device; base-level extension + dedup normalizes both
    paths to the same maximal matches.  Output rows are sorted canonically
    so the result is independent of the mesh size.
    """
    from mauvealigner_tpu.core.match import MatchList
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import multihost
    from mauvealigner_tpu.utils import timing

    n_seqs = len(genomes)
    keys, seq_ids, pos = matchops._concat_device_smls(smls_dev)
    N = int(keys.shape[0])
    D = mesh.devices.size
    if N % D:  # non-power-of-two meshes: pad the entry rows to divide
        padn = (-N) % D
        keys = jnp.concatenate(
            [keys, jnp.full(padn, merops.INVALID_KEY, jnp.int64)]
        )
        seq_ids = jnp.concatenate([seq_ids, jnp.zeros(padn, jnp.int32)])
        pos = jnp.concatenate([pos, jnp.zeros(padn, jnp.int32)])
        N += padn
    if jax.process_count() > 1:
        # multi-process (DCN) path: genomes are replicated per host, so the
        # locally-built entry arrays re-scatter into the global mesh
        keys = multihost.scatter_global(np.asarray(keys), mesh)
        seq_ids = multihost.scatter_global(np.asarray(seq_ids), mesh)
        pos = multihost.scatter_global(np.asarray(pos), mesh)
    cf = 1.7
    cap_local = max(1 << 12, (N >> 3) // D)
    while True:
        C1 = -(-int(N * cf) // (D * D))
        C1 = (C1 + 7) & ~7
        C2 = (int(C1 * cf) + 7) & ~7
        tabs, dropped = sharded_mum_candidate_tables(
            keys, seq_ids, pos, n_seqs, cap_local, C1, C2, mesh, min_multi
        )
        if int(multihost.fetch_replicated(dropped).sum()) > 0:
            cf *= 2.0
            continue
        # head-slice download: row 0 carries the run count and most results
        # fit in a few thousand rows — the full [D, cap_local+1, ...] table
        # is tens of MB to download (decode fetches taller slices only
        # when a device's count demands it)
        first = min(1 + (1 << 12), cap_local + 1)
        head_np = multihost.fetch_replicated(tabs[:, :first])
        n_runs = head_np[:, 0, 0]
        if (n_runs > cap_local).any():
            cap_local = 1 << int(int(n_runs.max()) - 1).bit_length()
            continue
        # record per-device work once, for the capacities that succeeded
        timing.GLOBAL.add(
            "k2_sharded_entries_per_device", float(N // D + D * C1 + D * C2)
        )
        break
    parts = [
        matchops.decode_mum_table(
            head_np[d], n_seqs, cap_local, seed_length,
            fetch=lambda rb, d=d: multihost.fetch_replicated(tabs[d, :rb]),
        )
        for d in range(D)
    ]
    ml = parts[0]
    for x in parts[1:]:
        ml = ml.concat(x)
    if extend and len(ml):
        ml = matchops.extend_matches_maximal(ml, [g.codes for g in genomes])
    elif len(ml):
        ml = ml.dedup()
    if nway:
        ml = ml.multiplicity_filter(n_seqs)
    if len(ml):
        order = np.lexsort(
            tuple(ml.starts[:, j] for j in range(n_seqs - 1, -1, -1))
        )
        ml = ml.select(order)
    return ml


def sharded_gotoh_scores(
    pa: jnp.ndarray,  # [B, M, 5] profiles
    pb: jnp.ndarray,  # [B, N, 5]
    lens_a: jnp.ndarray,
    lens_b: jnp.ndarray,
    mesh: Mesh,
    subst: Optional[jnp.ndarray] = None,
    gap_open: float = dp_ops.DEFAULT_GAP_OPEN,
    gap_extend: float = dp_ops.DEFAULT_GAP_EXTEND,
):
    """Batch-sharded Gotoh forward scores (B must divide by mesh size).

    KERNEL-LEVEL HARNESS ONLY: the model path shards DP batches through the
    ambient-mesh context (parallel.context.shard_batched_call); this exists
    for the mesh kernel tests (tests/test_parallel.py) and is not exported
    from the package namespace."""
    if subst is None:
        subst = jnp.asarray(dp_ops.HOXD70)
    M, N = pa.shape[1], pb.shape[1]

    def local(pa_l, pb_l, la_l, lb_l):
        # scored kernel: captures H[mA, mB] inside the scan instead of
        # materializing every H row — half the HBM per shard
        scores, _ = dp_ops.gotoh_forward_scored(
            pa_l, pb_l, la_l, lb_l, subst,
            jnp.float32(gap_open), jnp.float32(gap_extend), M, N,
        )
        return scores

    spec = P(AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )(pa, pb, lens_a, lens_b)


def sharded_hmm_posteriors(
    log_emit: jnp.ndarray,   # [B, T, S] (B must divide by mesh size)
    log_trans: jnp.ndarray,  # [S, S] (replicated)
    log_init: jnp.ndarray,   # [S] (replicated)
    lengths: jnp.ndarray,    # [B]
    mesh: Mesh,
) -> jnp.ndarray:
    """Batch-sharded K4 forward/backward: each device decodes its slice of
    the pairwise-projection batch with the log-depth associative scan.

    KERNEL-LEVEL HARNESS ONLY: the model path decodes through
    ops.hmm.bucketed_decode / pair_rows_state0_gt under the ambient-mesh
    context; kept for the mesh kernel tests (tests/test_parallel.py)."""
    from mauvealigner_tpu.ops import hmm as hmm_ops

    def local(le, lens):
        return hmm_ops.forward_backward(le, log_trans, log_init, lens)

    spec = P(AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
        check_vma=False,
    )(log_emit, lengths)


def sharded_pair_mum_tables(
    keys: jnp.ndarray,     # int64 [D, N] per-pair concatenated SML keys
    seq_ids: jnp.ndarray,  # int32 [D, N]
    pos: jnp.ndarray,      # int32 [D, N]
    n_seqs: int,
    cap: int,
    mesh: Mesh,
    min_multi: int = 2,
):
    """K2 unique-MUM candidate search for many independent genome pairs,
    sharded over the pair axis (D must divide by the mesh size).

    This is the pod-level axis of the draft workflow (BASELINE config 5,
    reference analog: per-process match partitioning via --match-log /
    --realign-lcb, src/mauveAligner.cpp:130-131,533-589): each device runs
    the full candidate kernel on its local reference-vs-draft pairs; the
    packed tables come back sharded and decode independently on host.
    """
    from mauvealigner_tpu.ops import matchops

    mask = jnp.ones(n_seqs, jnp.int32)

    def local(k, s, p):
        f = lambda kk, ss, pp: matchops.device_mum_candidates(
            kk, ss, pp, mask, n_seqs, cap, min_multi
        )
        return jax.vmap(f)(k, s, p)

    spec = P(AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )(keys, seq_ids, pos)


def find_pair_mums_sharded(
    ref,
    drafts,
    seed,
    mesh: Mesh,
    extend: bool = True,
):
    """Reference-vs-draft unique MUMs for every draft, pair-sharded over the
    mesh.  Returns one 2-sequence MatchList per draft (row 0 = ref).

    Host driver for the config-5 pod story: per-pair SMLs build on device,
    pairs pad to the mesh size (empty pads decode to empty lists), ONE
    sharded kernel launch covers every pair, and each table decodes with the
    same host decode as the single-chip path.
    """
    from mauvealigner_tpu.core.sml import build_mer_list_device
    from mauvealigner_tpu.ops import matchops
    from mauvealigner_tpu.parallel import multihost

    n_dev = mesh.devices.size
    D = len(drafts)
    if D == 0:
        return []
    ref_sml = build_mer_list_device(ref, seed)
    cols = [
        matchops._concat_device_smls([ref_sml, build_mer_list_device(d, seed)])
        for d in drafts
    ]
    # pairs may land in different length buckets; group launches by bucket
    out: list = [None] * D
    by_n: dict = {}
    for i, (k, _, _) in enumerate(cols):
        by_n.setdefault(int(k.shape[0]), []).append(i)
    for N, idxs in by_n.items():
        # pad this bucket's pair count to the mesh size (pad rows repeat a
        # real pair; their rows are simply not decoded)
        padded = list(idxs)
        while len(padded) % n_dev:
            padded.append(idxs[0])
        K = jnp.stack([cols[i][0] for i in padded])
        S = jnp.stack([cols[i][1] for i in padded])
        Ppos = jnp.stack([cols[i][2] for i in padded])
        if jax.process_count() > 1:
            # multi-process (DCN): host-replicated pair rows scatter into
            # the global mesh; results gather back to every process
            K = multihost.scatter_global(np.asarray(K), mesh)
            S = multihost.scatter_global(np.asarray(S), mesh)
            Ppos = multihost.scatter_global(np.asarray(Ppos), mesh)
        cap = max(1 << 14, N >> 3)
        while True:
            tabs = sharded_pair_mum_tables(K, S, Ppos, 2, cap, mesh)
            first = min(1 + (1 << 12), cap + 1)
            head = multihost.fetch_replicated(tabs[:, :first])
            n_runs = head[:, 0, 0]
            if (n_runs > cap).any():
                # capacity overflow (repeat-dense draft): retry with the
                # covering power of two, like the single-device search —
                # truncating would silently drop anchors
                cap = 1 << int(int(n_runs.max()) - 1).bit_length()
                continue
            break
        for row, i in enumerate(idxs):
            ml = matchops.decode_mum_table(
                head[row], 2, cap, seed.length,
                fetch=lambda rb, row=row: multihost.fetch_replicated(
                    tabs[row, :rb]
                ),
            )
            if extend and len(ml):
                ml = matchops.extend_matches_maximal(
                    ml, [ref.codes, drafts[i].codes]
                )
            out[i] = ml
    return out


def sort_contigs_sharded(
    ref,
    drafts,
    mesh: Mesh,
    seed_weight: Optional[int] = None,
):
    """Pod-level draft workflow front half (BASELINE config 5): the per-draft
    reference-vs-draft MUM searches shard over the mesh; LCB determination,
    placement walk and contig reordering stay on host per draft.

    Returns [(reordered genome, placement log)] per draft — exactly what the
    sequential sortContigs flow produces (tools/manipulate.sort_contigs).
    """
    from mauvealigner_tpu.models.lcb import greedy_breakpoint_elimination
    from mauvealigner_tpu.seeds import default_mer_size, get_seed
    from mauvealigner_tpu.tools.manipulate import (
        contig_placements_from_lcbs,
        sort_contigs,
    )

    if not drafts:
        return []
    # the sequential flow picks the default seed per (ref, draft) pair
    # (MauveAligner.find_mums averages the PAIR's lengths); group drafts by
    # that weight so every pair searches with the same seed it would get
    # sequentially
    by_weight: dict = {}
    for i, d in enumerate(drafts):
        w = seed_weight or default_mer_size(int(np.mean([len(ref), len(d)])))
        by_weight.setdefault(w, []).append(i)
    out: list = [None] * len(drafts)
    for weight, idxs in by_weight.items():
        seed = get_seed(weight, 0)
        mls = find_pair_mums_sharded(ref, [drafts[i] for i in idxs], seed, mesh)
        for i, ml in zip(idxs, mls):
            d = drafts[i]
            # mirror MauveAligner.determine_lcbs with default options:
            # n-way filter, overlap elimination, re-filter, then greedy
            # breakpoint elimination at seed_weight*3*n_seqs
            ml = ml.multiplicity_filter(2)
            ml = ml.eliminate_overlaps().multiplicity_filter(2)
            _, lcbs = greedy_breakpoint_elimination(ml, float(weight * 3 * 2))
            placements = contig_placements_from_lcbs(d, lcbs, draft_seq_index=1)
            out[i] = sort_contigs(d, placements)
    return out


def multichip_pipeline_step(
    mesh: Mesh,
    keys: jnp.ndarray,      # int64[N] concatenated per-genome mer entries
    seq_ids: jnp.ndarray,   # int32[N]
    positions: jnp.ndarray, # int32[N]
    n_seqs: int,
    cap_local: int,
    C1: int,
    C2: int,
    dp_pa: jnp.ndarray,
    dp_pb: jnp.ndarray,
    dp_la: jnp.ndarray,
    dp_lb: jnp.ndarray,
):
    """KERNEL-LEVEL HARNESS ONLY (mesh kernel tests): the model path runs
    the real pipeline over the mesh via the ambient context — see
    __graft_entry__.dryrun_multichip, which executes the actual
    tree-progressive flagship.

    One full sharded pipeline step: the REAL
    two-phase N-way anchor candidate search (all-to-all by mer hash, then by
    signature hash), batch-sharded Gotoh forward, and batch-sharded HMM
    posterior decode.

    Returns (candidate tables [D, cap_local+1, n_seqs+2], dropped [D],
    dp scores, per-element homology posterior means).
    """
    tabs, dropped = sharded_mum_candidate_tables(
        keys, seq_ids, positions, n_seqs, cap_local, C1, C2, mesh
    )
    scores = sharded_gotoh_scores(dp_pa, dp_pb, dp_la, dp_lb, mesh)
    # K4 slice: batch-sharded homology posterior decode on tiny shapes;
    # positive DP scores emit in favor of state 0 ("homologous")
    B = dp_pa.shape[0]
    hi = jnp.where(scores[:, None] > jnp.float32(0.0), -0.1, -2.0)
    lo = jnp.where(scores[:, None] > jnp.float32(0.0), -2.0, -0.1)
    le = jnp.stack(
        [jnp.broadcast_to(hi, (B, 8)), jnp.broadcast_to(lo, (B, 8))], axis=-1
    ).astype(jnp.float32)
    post = sharded_hmm_posteriors(
        le,
        jnp.log(jnp.asarray([[0.9, 0.1], [0.1, 0.9]], jnp.float32)),
        jnp.log(jnp.asarray([0.5, 0.5], jnp.float32)),
        jnp.full((B,), 8, jnp.int32),
        mesh,
    )
    return tabs, dropped, scores, post[:, :, 0].mean(axis=1)
