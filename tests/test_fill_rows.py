"""Equivalence of the row-scan fill with the anti-diagonal reference fill.

The diagonal fill (ops/fill_scan.py) is the semantically transparent
implementation validated against the reference's golden values
(tests/test_conformance.py); the row fill (ops/fill_rows.py) is the fast
formulation.  These tests pin them to each other bit-for-bit: final lanes,
full DP planes, move codes (via identical tracebacks), across simple and
BLOSUM schemes and padded batch mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from globalign_jax.ops import fill_rows, fill_scan
from globalign_jax.ops.traceback import traceback_moves
from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
from globalign_jax.utils.matrices import create_scoring_mat, load_bundled_matrix
from globalign_jax.utils.tokenize import Alphabet, encode_padded


def _dna_scheme():
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    return alpha, costing


def _random_pair(rng, letters, max_len=60):
    m = int(rng.integers(1, max_len))
    n = int(rng.integers(1, max_len))
    return (
        "".join(rng.choice(letters, m)),
        "".join(rng.choice(letters, n)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_row_fill_matches_diagonal_fill_dna(seed):
    alpha, costing = _dna_scheme()
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    rng = np.random.default_rng(seed)
    for _ in range(5):
        s1, s2 = _random_pair(rng, list("ACGT"))
        ta = jnp.asarray(encode_padded(alpha, s1, len(s1)))
        tb = jnp.asarray(encode_padded(alpha, s2, len(s2)))
        r_scan = fill_scan.wavefront_fill(
            ta, tb, cm, gid, go, want_moves=True, want_planes=True
        )
        r_rows = fill_rows.row_fill(
            ta, tb, cm, gid, go, want_moves=True, want_planes=True
        )
        assert (np.asarray(r_scan.final3) == np.asarray(r_rows.final3)).all()
        dense_scan = fill_scan.planes_to_dense(
            np.asarray(r_scan.planes), len(s1), len(s2)
        )
        dense_rows = np.minimum(np.asarray(r_rows.planes), fill_scan.BIG)
        assert (dense_scan == dense_rows).all()
        t_scan = traceback_moves(
            np.asarray(r_scan.moves), s1, s2, np.asarray(r_scan.final3), "diag"
        )
        t_rows = traceback_moves(
            np.asarray(r_rows.moves), s1, s2, np.asarray(r_rows.final3), "row"
        )
        assert t_scan == t_rows


def test_row_fill_matches_diagonal_fill_blosum62():
    """Asymmetric delta_d/delta_i gap costs (odd max score b=11)."""
    scoring = load_bundled_matrix("BLOSUM62")
    costing = scoring_mat_to_costing_mat(
        scoring, max_score=int(scoring.values.max())
    )
    alpha = costing.alphabet
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    letters = [c for c in alpha.letters if c != "-"]
    rng = np.random.default_rng(11)
    for _ in range(6):
        s1, s2 = _random_pair(rng, letters)
        ta = jnp.asarray(encode_padded(alpha, s1, len(s1)))
        tb = jnp.asarray(encode_padded(alpha, s2, len(s2)))
        r_scan = fill_scan.wavefront_fill(ta, tb, cm, gid, go, want_moves=True)
        r_rows = fill_rows.row_fill(ta, tb, cm, gid, go, want_moves=True)
        assert (np.asarray(r_scan.final3) == np.asarray(r_rows.final3)).all()
        t_scan = traceback_moves(
            np.asarray(r_scan.moves), s1, s2, np.asarray(r_scan.final3), "diag"
        )
        t_rows = traceback_moves(
            np.asarray(r_rows.moves), s1, s2, np.asarray(r_rows.final3), "row"
        )
        assert t_scan == t_rows


def test_row_fill_batch_padded_matches_scan():
    """Length-bucketed padded batch: per-pair results unaffected by padding."""
    alpha, costing = _dna_scheme()
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    rng = np.random.default_rng(5)
    B, M, N = 6, 40, 28
    tok_a = np.zeros((B, M + 1), np.int32)
    tok_b = np.zeros((B, N + 1), np.int32)
    mt = np.zeros(B, np.int32)
    nt = np.zeros(B, np.int32)
    seqs = []
    for b in range(B):
        m = int(rng.integers(1, M + 1))
        n = int(rng.integers(1, N + 1))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        tok_a[b] = encode_padded(alpha, s1, M)
        tok_b[b] = encode_padded(alpha, s2, N)
        mt[b], nt[b] = m, n
        seqs.append((s1, s2))
    rb = fill_rows.row_fill_batch(
        jnp.asarray(tok_a), jnp.asarray(tok_b), cm, gid, go,
        jnp.asarray(mt), jnp.asarray(nt), want_moves=True,
    )
    for b, (s1, s2) in enumerate(seqs):
        ta = jnp.asarray(encode_padded(alpha, s1, len(s1)))
        tb = jnp.asarray(encode_padded(alpha, s2, len(s2)))
        r1 = fill_scan.wavefront_fill(ta, tb, cm, gid, go, want_moves=True)
        assert (np.asarray(r1.final3) == np.asarray(rb.final3)[b]).all()
        t1 = traceback_moves(
            np.asarray(r1.moves), s1, s2, np.asarray(r1.final3), "diag"
        )
        t2 = traceback_moves(
            np.asarray(rb.moves)[b], s1, s2, np.asarray(rb.final3)[b], "row"
        )
        assert t1 == t2


def test_row_fill_last3_is_last_row():
    alpha, costing = _dna_scheme()
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    s1, s2 = "ACGTAC", "AGTC"
    ta = jnp.asarray(encode_padded(alpha, s1, len(s1)))
    tb = jnp.asarray(encode_padded(alpha, s2, len(s2)))
    r = fill_rows.row_fill(ta, tb, cm, gid, go, want_planes=True)
    assert (
        np.asarray(r.last3) == np.asarray(r.planes)[:, len(s1), :]
    ).all()
