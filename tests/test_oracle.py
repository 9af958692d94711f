"""Property tests against an independent numpy Gotoh oracle.

Covers what the reference never tested (SURVEY.md §4): agreement of the
wavefront fill with a textbook dense fill on random pairs, traced-path cost
== fill cost, and the score/cost invariant, across simple and BLOSUM schemes.
"""

import numpy as np
import pytest

from globalign_jax import draw_two_random_seqs, resolve_scheme
from globalign_jax.models.gotoh import GotohAligner
from globalign_jax.ops.traceback import alignment_cost
from globalign_jax.ops.transforms import split_deltas

from .oracle import oracle_cost, oracle_fill

DNA = ["A", "C", "G", "T"]
AA = list("ARNDCQEGHILKMFPSTWYV")


def random_cases():
    # Runs at COLLECTION time and must be deterministic across processes
    # (pytest-xdist requires identical test ids on every worker): the
    # generator's substitution leg reseeds from OS entropy when no seed is
    # given (reference call-order parity), so pin `random.seed(None)` to a
    # fixed seed for the duration of the draw.
    import random as _random

    orig_seed = _random.seed

    def _pinned(a=None, **kw):
        orig_seed(97 if a is None else a, **kw)

    _random.seed = _pinned
    try:
        cases = []
        for seed in range(6):
            div = [0.0, 0.15, 0.35, 0.6, 0.9, 1.0][seed]
            s1, s2 = draw_two_random_seqs(
                alphabet=DNA,
                min_len_seq_1=3,
                max_len_seq_1=40,
                min_len_seq_2=2,
                max_len_seq_2=50,
                divergence=div,
                seed_1=seed * 11 + 1,
                seed_2=seed * 7 + 3,
            )
            cases.append((s1, s2))
        return cases
    finally:
        _random.seed = orig_seed


@pytest.mark.parametrize("seq_1,seq_2", random_cases())
def test_fill_matches_oracle_simple_scheme(seq_1, seq_2):
    scheme = resolve_scheme(seq_1, seq_2, match_score=2, mismatch_score=-3)
    aligner = GotohAligner(scheme)

    got_planes = aligner.dp_planes(seq_1, seq_2)
    exp_planes = oracle_fill(seq_1, seq_2, scheme.costing, scheme.gap_open_cost)

    m, n = len(seq_1), len(seq_2)
    # Compare everywhere both are finite; the sentinel values differ (BIG vs
    # INF) but every reachable cell must agree exactly.
    finite = exp_planes < 10**8
    got = got_planes.astype(np.int64)
    assert (got[finite] == exp_planes[finite]).all()
    assert aligner.cost(seq_1, seq_2) == int(exp_planes[:, m, n].min())


@pytest.mark.parametrize("seq_1,seq_2", random_cases())
def test_traceback_cost_equals_fill_cost(seq_1, seq_2):
    scheme = resolve_scheme(seq_1, seq_2, mismatch_cost=5, gap_open_cost=4)
    aligner = GotohAligner(scheme)
    a = aligner.align(seq_1, seq_2)
    repriced = alignment_cost(
        a.seq_1_aligned, a.seq_2_aligned, scheme.costing, scheme.gap_open_cost
    )
    assert repriced == a.cost
    assert a.seq_1_aligned.replace("-", "") == seq_1
    assert a.seq_2_aligned.replace("-", "") == seq_2
    dd, di = split_deltas(scheme.max_score)
    assert a.score + a.cost == len(seq_2) * dd + len(seq_1) * di


def test_blosum62_protein_oracle():
    s1, s2 = draw_two_random_seqs(
        alphabet=AA,
        min_len_seq_1=10,
        max_len_seq_1=30,
        min_len_seq_2=10,
        max_len_seq_2=30,
        divergence=0.4,
        seed_1=5,
        seed_2=9,
    )
    scheme = resolve_scheme(s1, s2, scoring_mat_name="BLOSUM62")
    aligner = GotohAligner(scheme)
    assert aligner.cost(s1, s2) == oracle_cost(
        s1, s2, scheme.costing, scheme.gap_open_cost
    )
    a = aligner.align(s1, s2)
    assert (
        alignment_cost(
            a.seq_1_aligned, a.seq_2_aligned, scheme.costing, scheme.gap_open_cost
        )
        == a.cost
    )


def test_extreme_shapes():
    """Degenerate shapes: single characters, very asymmetric lengths."""
    for s1, s2 in [("A", "A"), ("A", "T"), ("A", "TTTTTTTT"), ("ACGTACGT", "C")]:
        scheme = resolve_scheme(s1, s2)
        aligner = GotohAligner(scheme)
        assert aligner.cost(s1, s2) == oracle_cost(
            s1, s2, scheme.costing, scheme.gap_open_cost
        )
        a = aligner.align(s1, s2)
        assert a.seq_1_aligned.replace("-", "") == s1
        assert a.seq_2_aligned.replace("-", "") == s2


def test_random_costing_matrices_vs_oracle():
    """Fuzz: arbitrary small non-negative costing matrices (asymmetric,
    random gap rows, random gap_open incl. 0) against the numpy oracle."""
    import numpy as np
    import jax.numpy as jnp

    from globalign_jax.ops import fill_rows
    from globalign_jax.utils.matrices import SubstitutionMatrix
    from globalign_jax.utils.tokenize import Alphabet, encode_padded

    from .oracle import oracle_cost

    rng = np.random.default_rng(123)
    for trial in range(30):
        A = int(rng.integers(2, 6))
        letters = tuple("ABCDE"[:A]) + ("-",)
        alpha = Alphabet.from_letters(letters)
        vals = rng.integers(0, 12, (A + 1, A + 1)).astype(np.int32)
        np.fill_diagonal(vals, rng.integers(0, 3, A + 1))
        go = int(rng.integers(0, 7))
        m = int(rng.integers(1, 25))
        n = int(rng.integers(1, 25))
        s1 = "".join(rng.choice(list(letters[:-1]), m))
        s2 = "".join(rng.choice(list(letters[:-1]), n))
        costing = SubstitutionMatrix(alpha, vals)
        want = oracle_cost(s1, s2, costing, go)
        ta = jnp.asarray(encode_padded(alpha, s1, m))
        tb = jnp.asarray(encode_padded(alpha, s2, n))
        got = int(
            np.asarray(
                fill_rows.row_fill(
                    ta, tb, jnp.asarray(vals), jnp.int32(alpha.gap_id),
                    jnp.int32(go), want_moves=False,
                ).final3
            ).min()
        )
        assert want == got, (trial, s1, s2, vals.tolist(), go, want, got)
