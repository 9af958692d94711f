"""Multi-device data-parallel path on the 8-device virtual CPU mesh.

The reference has no distributed anything (SURVEY.md §2); this is the
engine's multi-device scaling axis, validated without hardware via
xla_force_host_platform_device_count (SURVEY.md §4 item 3).
"""

import jax
import numpy as np
import pytest

from globalign_jax import align_pairs, find_global_alignment
from globalign_jax.parallel.mesh import make_pair_mesh


def test_virtual_mesh_has_8_devices(cpu_mesh):
    assert cpu_mesh.devices.size == 8


def test_sharded_costs_match_unsharded(cpu_mesh):
    pairs = [
        ("ACGT", "AGT"),
        ("TT", "TA"),
        ("TAAAGCTAA", "TAGCTC"),
        ("GGAGGACGTT", "GAG"),
        ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT"),
        ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA"),
        ("CTGTACCG", "CGGAACAGTCCGAT"),
        ("GTAGGCGGTC", "CAGCTGC"),
        ("ACGTACGT", "ACGTACGT"),
        ("AAAA", "AA"),  # 10 pairs over 8 devices: exercises pad+drop
    ]
    sharded = align_pairs(pairs, with_traceback=False, mesh=cpu_mesh)
    local = align_pairs(pairs, with_traceback=False)
    for s, l in zip(sharded, local):
        assert s.cost == l.cost
        assert s.score == l.score


def test_sharded_matches_reference_goldens(cpu_mesh):
    pairs = [("TT", "TA"), ("GGAGGACGTT", "GAG")]
    out = align_pairs(
        pairs,
        with_traceback=False,
        mesh=cpu_mesh,
        match_score=3,
        mismatch_score=-4,
        gap_open_score=-5,
        gap_extension_score=-2,
    )
    assert (out[0].score, out[0].cost) == (-1, 7)


def test_sharded_traceback_matches_unsharded(cpu_mesh):
    """Sharded batches produce full alignments (round-1 limitation lifted):
    moves stay sharded per device, final lanes are all-gathered, and the
    deterministic traceback is bit-identical to the local path."""
    rng = np.random.default_rng(77)
    pairs = []
    for _ in range(13):  # odd count -> exercises mesh padding
        m = int(rng.integers(1, 60))
        n = int(rng.integers(1, 60))
        pairs.append(
            (
                "".join(rng.choice(list("ACGT"), m)),
                "".join(rng.choice(list("ACGT"), n)),
            )
        )
    sharded = align_pairs(pairs, with_traceback=True, mesh=cpu_mesh)
    local = align_pairs(pairs, with_traceback=True)
    for s, l in zip(sharded, local):
        assert (s.cost, s.score) == (l.cost, l.score)
        assert s.seq_1_aligned == l.seq_1_aligned
        assert s.middle_part == l.middle_part
        assert s.seq_2_aligned == l.seq_2_aligned


def _token_batch(name, B=10, M=23, N=17, seed=0):
    from .schemes import scheme

    letters, costing, go = scheme(name)
    rng = np.random.default_rng(seed)
    a = costing.alphabet
    tok_a = np.zeros((B, M + 1), np.int32)
    tok_b = np.zeros((B, N + 1), np.int32)
    mt = rng.integers(1, M + 1, B).astype(np.int32)
    nt = rng.integers(1, N + 1, B).astype(np.int32)
    seqs = []
    for b in range(B):
        s1 = "".join(rng.choice(list(letters), mt[b]))
        s2 = "".join(rng.choice(list(letters), nt[b]))
        tok_a[b, 1 : mt[b] + 1] = a.encode(s1)
        tok_b[b, 1 : nt[b] + 1] = a.encode(s2)
        seqs.append((s1, s2))
    consts = (costing.values, a.gap_id, go)
    return tok_a, tok_b, consts, mt, nt, seqs


@pytest.mark.parametrize("mode", ["costs", "moves"])
@pytest.mark.parametrize("name", ["dna_default", "BLOSUM62", "odd_b",
                                  "alpha_29_0"])
def test_sharded_fill_matches_unsharded_grid(cpu_mesh, name, mode):
    """The shard_map fills over the 8-device mesh (10 pairs: pad + drop)
    equal the unsharded row scan: final lanes, and move codes walked to
    identical alignments."""
    import jax.numpy as jnp

    from globalign_jax.ops import fill_rows
    from globalign_jax.ops.traceback import traceback_moves
    from globalign_jax.parallel import mesh as mesh_mod

    tok_a, tok_b, consts, mt, nt, seqs = _token_batch(name)
    ref = fill_rows.row_fill_batch(
        jnp.asarray(tok_a), jnp.asarray(tok_b), *(jnp.asarray(c) for c in
                                                  consts),
        jnp.asarray(mt), jnp.asarray(nt), want_moves=True,
    )
    ref_f3 = np.asarray(ref.final3)
    if mode == "costs":
        f3 = mesh_mod.sharded_fill_costs(cpu_mesh, tok_a, tok_b, *consts,
                                         mt, nt)
        assert (f3 == ref_f3).all()
        return
    f3, moves = mesh_mod.sharded_fill_moves(cpu_mesh, tok_a, tok_b, *consts,
                                            mt, nt)
    assert (f3 == ref_f3).all()
    assert moves.shape == np.asarray(ref.moves).shape
    for b, (s1, s2) in enumerate(seqs):
        assert traceback_moves(moves[b], s1, s2, f3[b], "row") == (
            traceback_moves(np.asarray(ref.moves[b]), s1, s2, ref_f3[b],
                            "row")
        ), b


def test_sharded_moves_land_on_every_device(cpu_mesh):
    """The move planes stay sharded: one batch shard per mesh device."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from globalign_jax.parallel import mesh as mesh_mod

    tok_a, tok_b, consts, mt, nt, _ = _token_batch("dna_default", B=16)
    sh = NamedSharding(cpu_mesh, P(mesh_mod.BATCH_AXIS))
    final3, moves = mesh_mod._sharded_moves_jit(
        cpu_mesh, mesh_mod._put(tok_a, sh), mesh_mod._put(tok_b, sh),
        *(jnp.asarray(c) for c in consts), mesh_mod._put(mt, sh),
        mesh_mod._put(nt, sh),
    )
    devs = {s.device for s in moves.addressable_shards}
    assert len(devs) == cpu_mesh.devices.size
    assert all(s.data.shape[0] == 2 for s in moves.addressable_shards)
    assert final3.shape == (16, 3)


def test_sharded_traceback_blosum_matches_unsharded(cpu_mesh):
    rng = np.random.default_rng(8)
    prot = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [
        ("".join(rng.choice(prot, int(rng.integers(5, 40)))),
         "".join(rng.choice(prot, int(rng.integers(5, 40)))))
        for _ in range(11)
    ]
    kw = dict(scoring_mat_name="BLOSUM62", with_traceback=True)
    assert align_pairs(pairs, mesh=cpu_mesh, **kw) == align_pairs(pairs, **kw)


def test_graft_entry_forward_step():
    """The jittable entry step returns the oracle cost of every pair."""
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from globalign_jax.ops import fill_scan

    fn, args = ge.entry()
    got = np.asarray(jax.jit(fn)(*args))
    costing = ge._simple_costing()
    ref = fill_scan.wavefront_fill_batch(
        *args[:2], jnp.asarray(costing.values),
        jnp.int32(costing.alphabet.gap_id), jnp.int32(4), *args[2:],
    )
    assert (got == np.asarray(ref.final3).min(axis=-1)).all()


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dryrun_multichip(n_devices, capsys):
    import __graft_entry__ as ge

    ge.dryrun_multichip(n_devices)
    assert f"{n_devices} devices" in capsys.readouterr().out
