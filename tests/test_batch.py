"""Batched pair engine: bucketing, padding, per-pair extraction."""

import pytest

from globalign_jax import align_pairs, find_global_alignment
from globalign_jax.batch import bucket_length
from globalign_jax.ops.traceback import alignment_cost
from globalign_jax.utils.matrices import SubstitutionMatrix

PAIRS = [
    ("ACGT", "AGT"),
    ("TT", "TA"),
    ("TAAAGCTAA", "TAGCTC"),
    ("GGAGGACGTT", "GAG"),
    ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT"),
    ("A", "TTTTTTTT"),
    ("ACGTACGTACGTACGTACGTACGTACGTACGTACGT", "ACGT"),  # crosses a bucket edge
]


def test_bucket_length():
    assert bucket_length(1, 32) == 32
    assert bucket_length(32, 32) == 32
    assert bucket_length(33, 32) == 64
    assert bucket_length(150, 32) == 160


def test_align_pairs_matches_single_pair_api():
    batched = align_pairs(PAIRS)
    for (s1, s2), got in zip(PAIRS, batched):
        single = find_global_alignment(seq_1=s1, seq_2=s2)
        assert got.cost == single.cost
        assert got.score == single.score
        # Deterministic engine: batched and single tracebacks are identical.
        assert got.seq_1_aligned == single.seq_1_aligned
        assert got.seq_2_aligned == single.seq_2_aligned
        assert got.middle_part == single.middle_part


def test_align_pairs_cost_only():
    costs = align_pairs(PAIRS, with_traceback=False)
    full = align_pairs(PAIRS, with_traceback=True)
    for c, f in zip(costs, full):
        assert c.cost == f.cost
        assert c.score == f.score
        assert c.seq_1_aligned is None


def test_align_pairs_custom_scheme():
    batched = align_pairs(
        [("TT", "TA"), ("GGAGGACGTT", "GAG")],
        match_score=3,
        mismatch_score=-4,
        gap_open_score=-5,
        gap_extension_score=-2,
    )
    assert (batched[0].score, batched[0].cost) == (-1, 7)


def test_align_pairs_blosum():
    pairs = [("MKV", "MKV"), ("HEAGAWGHEE", "PAWHEAE")]
    out = align_pairs(pairs, scoring_mat_name="BLOSUM62")
    for (s1, s2), r in zip(pairs, out):
        single = find_global_alignment(
            seq_1=s1, seq_2=s2, scoring_mat_name="BLOSUM62"
        )
        assert (r.cost, r.score) == (single.cost, single.score)
        costing = SubstitutionMatrix.from_nested_dict(single.costing_mat)
        assert (
            alignment_cost(
                r.seq_1_aligned, r.seq_2_aligned, costing, single.gap_open_cost
            )
            == r.cost
        )


def test_align_pairs_validation():
    with pytest.raises(RuntimeError):
        align_pairs([("", "ACGT")])
    with pytest.raises(RuntimeError):
        align_pairs([("AC-T", "ACGT")])
    assert align_pairs([]) == []


def test_batch_traceback_moves_budget_fallback(monkeypatch):
    """Buckets whose move matrices exceed the budget go through the
    blocked per-pair traceback and still produce identical alignments."""
    import numpy as np

    import globalign_jax.batch as batch_mod
    from globalign_jax.batch import align_pairs

    rng = np.random.default_rng(3)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), 80)),
            "".join(rng.choice(list("ACGT"), 70)),
        )
        for _ in range(3)
    ]
    want = align_pairs(pairs, with_traceback=True)
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", 64)
    got = align_pairs(pairs, with_traceback=True)
    assert want == got


def test_batch_traceback_subbatch_split(monkeypatch):
    """A bucket slightly over the moves budget is split into sub-batches
    (keeping the batched path), not degraded to per-pair replay."""
    import numpy as np

    import globalign_jax.batch as batch_mod
    from globalign_jax.batch import align_pairs

    rng = np.random.default_rng(7)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), 30)),
            "".join(rng.choice(list("ACGT"), 30)),
        )
        for _ in range(5)
    ]
    want = align_pairs(pairs, with_traceback=True)
    # Budget fits ~1 pair per sub-batch: (31)*(128 padded cols) ~ 4k
    monkeypatch.setattr(batch_mod, "DEFAULT_BATCH_MOVES_BUDGET", 5000)
    got = align_pairs(pairs, with_traceback=True)
    assert want == got


def test_deferred_cost_flush_accounting():
    """Cost-only mode defers every bucket's finals into ONE coalesced
    fetch across 2+ buckets: ``flush=False`` returns a pending handle
    whose ``resolve()`` fetches, records a "fetch" phase, and gives the
    eager results in input order."""
    import globalign_jax.batch as batch_mod

    want = batch_mod.align_pairs(PAIRS, with_traceback=False)
    phases: dict = {}
    pending = batch_mod.align_pairs(
        PAIRS, with_traceback=False, flush=False, phase_seconds=phases
    )
    assert isinstance(pending, batch_mod.PendingAlignments)
    assert "fetch" not in phases
    assert len({(batch_mod.bucket_length(len(a)), batch_mod.bucket_length(
        len(b))) for a, b in PAIRS}) >= 2
    got = pending.resolve()
    assert "fetch" in phases
    assert want == got
