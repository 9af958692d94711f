"""The ``globalign`` drop-in shim behaves like the reference package.

Runs the reference test suite's key expectations through the shim's module
paths and dict-based signatures (reference tests/globaligner_test.py,
tests/start_test.py).
"""

import pytest


def test_shim_import_layout():
    import globalign
    from globalign import conclude, globaligner, start

    assert globalign.find_global_alignment is globaligner.find_global_alignment
    assert callable(start.scoring_mat_to_costing_mat)
    assert callable(conclude.final_cost_to_score)


# Reference end-to-end golden (score, cost) vectors
# (reference tests/globaligner_test.py:315-383; the full nine are pinned in
# tests/test_conformance.py — a representative subset here via the shim).
REFERENCE_E2E = [
    dict(seq_1="TT", seq_2="TA", match_score=3, mismatch_score=-4,
         gap_open_score=-5, gap_extension_score=-2, score=-1, cost=7),
    dict(seq_1="ACGT", seq_2="AGT", score=0, cost=7),
    dict(seq_1="TAAAGCTAA", seq_2="TAGCTC", match_score=2, mismatch_score=-3,
         gap_open_score=-5, gap_extension_score=-2, score=-9, cost=24),
    dict(seq_1="GGAGGACGTT", seq_2="GAG", match_score="1",
         mismatch_score="-2", gap_open_score="-5", gap_extension_score="-2",
         score=-21, cost=31),
]


@pytest.mark.parametrize("case", REFERENCE_E2E)
def test_shim_find_global_alignment_goldens(case):
    from globalign.globaligner import find_global_alignment

    case = dict(case)
    want_score, want_cost = case.pop("score"), case.pop("cost")
    r = find_global_alignment(**case)
    assert (r.score, r.cost) == (want_score, want_cost)


def test_shim_dict_matrix_helpers():
    from globalign.start import (
        check_big_main_diag,
        check_symmetric,
        costing_mat_to_scoring_mat,
        create_costing_mat,
        create_scoring_mat,
        get_common_alphabet,
        get_max_val,
        scoring_mat_to_costing_mat,
    )

    alpha = get_common_alphabet("ACGT", "AGT")
    assert alpha == ["A", "C", "G", "T"]
    scoring = create_scoring_mat(list(alpha), 2, -3, -2)
    assert alpha == ["A", "C", "G", "T"]  # copy passed; original intact
    assert set(scoring) == {"A", "C", "G", "T", "-"}
    assert scoring["A"]["A"] == 2 and scoring["A"]["C"] == -3
    assert scoring["A"]["-"] == -2
    assert check_symmetric(scoring) and check_big_main_diag(scoring)
    assert get_max_val(scoring) == 2

    costing = scoring_mat_to_costing_mat(scoring, max_score=2)
    # b=2 -> delta_d = delta_i = 1: diagonal cost 0, mismatch 5, gap 3
    assert costing["A"]["A"] == 0
    assert costing["A"]["C"] == 5
    assert costing["-"]["A"] == 3 and costing["A"]["-"] == 3
    back = costing_mat_to_scoring_mat(costing, max_score=2)
    assert back == scoring

    costing2 = create_costing_mat(["A", "C"], 5, 3)
    assert costing2["A"]["A"] == 0 and costing2["A"]["-"] == 3


def test_shim_check_symmetric_error_surface():
    """Non-dict input raises AttributeError like the reference
    (reference tests/start_test.py:42-65)."""
    from globalign.start import check_symmetric

    assert check_symmetric({"A": {"A": 1, "B": 2}, "B": {"A": 2, "B": 1}})
    assert not check_symmetric({"A": {"A": 1, "B": 2}, "B": {"A": 3, "B": 1}})
    with pytest.raises(AttributeError):
        check_symmetric([[0, 1], [1, 0]])


def test_shim_validate_and_transform_args_seven_tuple():
    from globalign.start import validate_and_transform_args

    out = validate_and_transform_args(seq_1="ACGT", seq_2="AGT")
    assert len(out) == 7
    seq_1, seq_2, scoring_mat, costing_mat, go_s, go_c, output = out
    assert (seq_1, seq_2) == ("ACGT", "AGT")
    assert scoring_mat["A"]["A"] == 2 and costing_mat["A"]["A"] == 0
    assert (go_s, go_c) == (-4, 4)
    assert output is None


def test_shim_final_transforms_and_allocators():
    from globalign.conclude import final_cost_to_score, final_score_to_cost
    from globalign.start import make_3d_array, make_matrix

    assert final_cost_to_score(cost=7, m=4, n=3, max_score=2) == 0
    assert final_score_to_cost(score=0, m=4, n=3, max_score=2) == 7
    m = make_matrix(2, 3, 0)
    assert m == [[0, 0, 0], [0, 0, 0]]
    m[0][0] = 9
    assert m[1][0] == 0  # rows independent
    a = make_3d_array(2, 2, 2, "x")
    a[0][0][0] = "y"
    assert a[1][0][0] == "x"


def test_shim_create_scoring_mat_mutates_like_reference():
    """The reference appends '-' to the caller's alphabet list."""
    from globalign.start import create_scoring_mat

    alpha = ["A", "C"]
    create_scoring_mat(alpha, 1, -1, -1)
    assert alpha == ["A", "C", "-"]


def test_dp_array_forward_reference_golden():
    """The reference's OWN golden case for dp_array_forward
    (reference tests/globaligner_test.py:6-37): a hand-seeded boundary,
    exact (M, Ix, Iy) tuples after the fill."""
    from globalign.globaligner import dp_array_forward

    dp_array = [
        [(0, 7, 7), (6, 3, 9), (5, 5, 11)],
        [(4, 10, 4), None, None],
        [(10, 13, 7), None, None],
    ]
    costing_mat = {
        "A": {"A": 0, "G": 3, "-": 3},
        "G": {"A": 3, "G": 0, "-": 3},
        "-": {"A": 2, "G": 2, "-": 0},
    }
    dp_array_forward(dp_array, "AG", "GA", costing_mat, 1)
    assert dp_array == [
        [(0, 7, 7), (6, 3, 9), (5, 5, 11)],
        [(4, 10, 4), (3, 7, 7), (3, 6, 9)],
        [(10, 13, 7), (4, 10, 7), (6, 7, 7)],
    ]


def test_dp_compat_end_to_end_matches_engine():
    """make_dp_array + dp_array_forward + dp_array_backward reproduce
    the engine's cost, and the emitted alignment prices to it."""
    from globalign.globaligner import (
        dp_array_backward,
        dp_array_forward,
        make_dp_array,
    )
    from globalign_jax import find_global_alignment
    from globalign_jax.ops.traceback import alignment_cost
    from globalign_jax.utils.matrices import SubstitutionMatrix

    for s1, s2 in [("ACGT", "AGT"), ("TAAAGCTAA", "TAGCTC"),
                   ("A", "TTTT"), ("GATTACA", "GATTACA")]:
        res = find_global_alignment(seq_1=s1, seq_2=s2)
        costing = res.costing_mat
        max_cost = max(
            v for row in costing.values() for v in row.values()
        )
        dp = make_dp_array(s1, s2, costing, max_cost, res.gap_open_cost)
        dp_array_forward(dp, s1, s2, costing, res.gap_open_cost)
        s1a, mid, s2a, cost = dp_array_backward(
            dp, s1, s2, costing, res.gap_open_cost
        )
        assert cost == res.cost
        assert len(s1a) == len(mid) == len(s2a)
        sub = SubstitutionMatrix.from_nested_dict(costing)
        assert alignment_cost(s1a, s2a, sub, res.gap_open_cost) == cost


def test_dp_compat_take_functions():
    from globalign.globaligner import (
        take_gap_in_seq_1,
        take_gap_in_seq_2,
        take_match,
        take_mismatch,
    )

    o1, mid, o2 = [], [], []
    take_match("AC", "AG", 0, 0, o1, mid, o2)
    take_mismatch("AC", "AG", 1, 1, o1, mid, o2)
    take_gap_in_seq_1("AC", "AG", 1, 1, o1, mid, o2)
    take_gap_in_seq_2("AC", "AG", 1, 1, o1, mid, o2)
    assert o1 == ["A", "C", "-", "C"]
    assert mid == ["|", "*", " ", " "]
    assert o2 == ["A", "G", "G", "-"]
