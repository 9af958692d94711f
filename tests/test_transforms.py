"""Score<->cost transform properties (reference start.py:500-612, conclude.py:154-202)."""

import numpy as np
import pytest

from globalign_jax import (
    costing_mat_to_scoring_mat,
    final_cost_to_score,
    final_score_to_cost,
    load_bundled_matrix,
    scoring_mat_to_costing_mat,
)
from globalign_jax.ops.transforms import split_deltas


def test_split_deltas():
    assert split_deltas(11) == (5, 6)
    assert split_deltas(2) == (1, 1)
    assert split_deltas(3) == (1, 2)
    assert split_deltas(1) == (0, 1)


def test_blosum62_transform_asymmetric_gap_costs():
    """BLOSUM62 has b=11 (odd), so delta_d=5 != delta_i=6: the transformed
    gap costs are asymmetric (9 for '-'/M deletions vs 10 for M/'-'
    insertions) — SURVEY.md §2 C8, verified against the reference."""
    scoring = load_bundled_matrix("BLOSUM62")
    assert scoring.max_val() == 11
    costing = scoring_mat_to_costing_mat(scoring, max_score=11)
    assert costing.lookup("-", "M") == -scoring.lookup("-", "M") + 5  # == 9
    assert costing.lookup("M", "-") == -scoring.lookup("M", "-") + 6  # == 10
    assert costing.lookup("-", "M") == 9
    assert costing.lookup("M", "-") == 10
    # Match/mismatch entries get delta_d + delta_i.
    assert costing.lookup("A", "A") == -4 + 11
    assert costing.lookup("W", "W") == -11 + 11


@pytest.mark.parametrize("name", ["BLOSUM50", "BLOSUM62", "nucleotide"])
def test_transform_round_trip(name):
    scoring = load_bundled_matrix(name)
    b = scoring.max_val()
    costing = scoring_mat_to_costing_mat(scoring, max_score=b)
    back = costing_mat_to_scoring_mat(costing, max_score=b)
    np.testing.assert_array_equal(back.values, scoring.values)


def test_costing_is_valid_distance_matrix():
    """Transformed BLOSUM62 costs are non-negative (a valid distance matrix
    is the whole point of the transform)."""
    scoring = load_bundled_matrix("BLOSUM62")
    costing = scoring_mat_to_costing_mat(scoring, max_score=scoring.max_val())
    assert int(costing.values.min()) >= 0
    # Diagonal (match) costs are minimal within their row for the AA block.
    v = costing.values
    for i in range(20):
        assert v[i, i] == v[i, :20].min()


def test_final_transforms_inverse():
    for m, n, b in [(5, 7, 2), (10, 3, 11), (4, 4, 3)]:
        for cost in [0, 7, 31, 102]:
            score = final_cost_to_score(cost, m=m, n=n, max_score=b)
            assert final_score_to_cost(score, m=m, n=n, max_score=b) == cost
            dd, di = split_deltas(b)
            assert score + cost == n * dd + m * di
