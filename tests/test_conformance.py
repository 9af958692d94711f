"""Conformance floor: the reference's golden test vectors.

(1) the 9 end-to-end (score, cost) pairs from the reference suite
    (reference tests/globaligner_test.py:40-383), including the string-typed
    arg-coercion case;
(2) the golden forward-fill DP array with a pre-seeded boundary
    (reference tests/globaligner_test.py:6-37).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from globalign_jax import find_global_alignment
from globalign_jax.ops import fill_scan
from globalign_jax.ops.traceback import alignment_cost
from globalign_jax.utils.matrices import SubstitutionMatrix

GOLDEN_E2E = [
    # (seq_1, seq_2, match, mismatch, gap_open_score, gap_ext_score,
    #  expected_score, expected_cost)
    ("TT", "TA", 3, -4, -5, -2, -1, 7),
    ("TAAAGCTAA", "TAGCTC", 2, -3, -5, -2, -9, 24),
    ("TGGATGAGGCTCCACGCACTAA", "GATTGGTGAGGCTCAGCAT", 2, -3, -5, -2, -15, 56),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 2, -3, -5, -2, -21, 62),
    ("CGGTCTTAGCATATGTTGGCATAC", "ATTAGCATCATAGTGGA", 4, -5, -3, -5, -20, 102),
    ("GTAGGCGGTC", "CAGCTGC", 1, -2, -5, -2, -18, 28),
    ("CTGTACCG", "CGGAACAGTCCGAT", 1, -2, -5, -2, -18, 26),
    ("GGAGGACGTT", "GAG", 1, -2, -5, -2, -21, 31),
    ("GGAGGACGTT", "GAG", "1", "-2", "-5", "-2", -21, 31),  # string coercion
]


@pytest.mark.parametrize(
    "seq_1,seq_2,match,mismatch,gap_open,gap_ext,exp_score,exp_cost", GOLDEN_E2E
)
def test_find_global_alignment_golden(
    seq_1, seq_2, match, mismatch, gap_open, gap_ext, exp_score, exp_cost
):
    r = find_global_alignment(
        seq_1=seq_1,
        seq_2=seq_2,
        match_score=match,
        mismatch_score=mismatch,
        gap_open_score=gap_open,
        gap_extension_score=gap_ext,
    )
    assert r.score == exp_score
    assert r.cost == exp_cost
    # Beyond the reference's asserts: the emitted alignment itself must price
    # to the optimal cost under the costing scheme.
    costing = SubstitutionMatrix.from_nested_dict(r.costing_mat)
    assert (
        alignment_cost(
            r.seq_1_aligned, r.seq_2_aligned, costing, r.gap_open_cost
        )
        == r.cost
    )
    # And the alignment must be a valid gapped spelling of the inputs.
    assert r.seq_1_aligned.replace("-", "") == seq_1
    assert r.seq_2_aligned.replace("-", "") == seq_2
    assert len(r.seq_1_aligned) == len(r.middle_part) == len(r.seq_2_aligned)


def test_forward_fill_golden_array():
    """The reference's one golden DP-array fill (globaligner_test.py:6-37).

    The test pre-seeds a custom boundary; the engine accepts explicit
    row0/col0 for exactly this contract.
    """
    seq_1, seq_2 = "AG", "GA"
    costing = SubstitutionMatrix.from_nested_dict(
        {
            "A": {"A": 0, "G": 3, "-": 3},
            "G": {"A": 3, "G": 0, "-": 3},
            "-": {"A": 2, "G": 2, "-": 0},
        }
    )
    gap_open = 1
    alphabet = costing.alphabet

    # Pre-seeded boundary from the golden dp_array.
    row0 = jnp.asarray(
        np.array([[0, 6, 5], [7, 3, 5], [7, 9, 11]], np.int32)
    )  # (3, n+1): [level, j]
    col0 = jnp.asarray(np.array([[0, 4, 10], [7, 10, 13], [7, 4, 7]], np.int32))

    tok_a = jnp.asarray(
        np.array([0] + [alphabet.index(c) for c in seq_1], np.int32)
    )
    tok_b = jnp.asarray(
        np.array([0] + [alphabet.index(c) for c in seq_2], np.int32)
    )

    res = fill_scan.wavefront_fill(
        tok_a,
        tok_b,
        jnp.asarray(costing.values),
        jnp.int32(alphabet.gap_id),
        jnp.int32(gap_open),
        row0=row0,
        col0=col0,
        want_moves=False,
        want_planes=True,
    )
    dense = fill_scan.planes_to_dense(np.asarray(res.planes), 2, 2)

    expected = [
        [(0, 7, 7), (6, 3, 9), (5, 5, 11)],
        [(4, 10, 4), (3, 7, 7), (3, 6, 9)],
        [(10, 13, 7), (4, 10, 7), (6, 7, 7)],
    ]
    for i in range(3):
        for j in range(3):
            got = tuple(int(dense[lvl, i, j]) for lvl in range(3))
            assert got == expected[i][j], f"cell ({i},{j}): {got} != {expected[i][j]}"


def test_tutorial_golden_alignment():
    """The tutorial's end-to-end default-settings case (tutorial.qmd:19-24)."""
    r = find_global_alignment(seq_1="ACGT", seq_2="AGT")
    assert r.score == 0
    assert r.cost == 7
    assert r.seq_1_aligned == "ACGT"
    assert r.middle_part == "| ||"
    assert r.seq_2_aligned == "A-GT"
