"""Argument validation parity (reference start.py:10-353)."""

import pytest

from globalign_jax import (
    SimpleCostingSettings,
    SimpleScoringSettings,
    find_global_alignment,
    validate_and_transform_args,
)


def test_simple_settings_defaults_and_coercion():
    s = SimpleScoringSettings(None, None, None, None)
    assert (s.match_score, s.mismatch_score, s.gap_open_score,
            s.gap_extension_score) == (2, -3, -4, -2)
    s = SimpleScoringSettings("3", "-4", "-5", "-2")
    assert (s.match_score, s.mismatch_score) == (3, -4)
    c = SimpleCostingSettings(None, None, None)
    assert (c.mismatch_cost, c.gap_open_cost, c.gap_extension_cost) == (5, 4, 3)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(match_score=0),
        dict(match_score=-1),
        dict(mismatch_score=1),
        dict(gap_open_score=2),
        dict(gap_extension_score=0),
    ],
)
def test_scoring_sign_rules(kwargs):
    with pytest.raises(ValueError):
        SimpleScoringSettings(**{**dict(match_score=None, mismatch_score=None,
                                        gap_open_score=None,
                                        gap_extension_score=None), **kwargs})


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(mismatch_cost=0),
        dict(gap_open_cost=-1),
        dict(gap_extension_cost=0),
    ],
)
def test_costing_sign_rules(kwargs):
    with pytest.raises(ValueError):
        SimpleCostingSettings(**{**dict(mismatch_cost=None, gap_open_cost=None,
                                        gap_extension_cost=None), **kwargs})


def test_coercion_error():
    with pytest.raises((TypeError, ValueError)):
        SimpleScoringSettings(match_score="abc")


def test_gap_open_coupling():
    v = validate_and_transform_args(seq_1="AC", seq_2="AC", gap_open_score=-7)
    assert v.scheme.gap_open_score == -7
    assert v.scheme.gap_open_cost == 7
    v = validate_and_transform_args(seq_1="AC", seq_2="AC", gap_open_cost=9)
    assert v.scheme.gap_open_cost == 9
    assert v.scheme.gap_open_score == -9
    v = validate_and_transform_args(seq_1="AC", seq_2="AC")
    assert (v.scheme.gap_open_score, v.scheme.gap_open_cost) == (-4, 4)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(seq_1="AC"),  # seq_2 missing
        dict(seq_2="AC"),  # seq_1 missing
        dict(),  # nothing given
        dict(input_fasta="x.fa", seq_1="AC", seq_2="GT"),  # both sources
    ],
)
def test_input_combination_rules(kwargs):
    with pytest.raises(RuntimeError):
        validate_and_transform_args(**kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scoring_mat_name="BLOSUM62", match_score=2),
        dict(scoring_mat_name="BLOSUM62", mismatch_cost=5),
        dict(scoring_mat_name="BLOSUM62", scoring_mat_path="x.mtx"),
        dict(scoring_mat_path="x.mtx", gap_extension_cost=3),
        dict(match_score=2, mismatch_cost=5),
        dict(gap_open_score=-4, gap_open_cost=4),
    ],
)
def test_scheme_exclusion_rules(kwargs):
    with pytest.raises(RuntimeError):
        validate_and_transform_args(seq_1="ACGT", seq_2="AGT", **kwargs)


def test_gap_open_allowed_with_matrix():
    # gap_open options ARE allowed with a matrix (start.py:227-228).
    r = find_global_alignment(
        seq_1="MKV", seq_2="MKV", scoring_mat_name="BLOSUM62", gap_open_cost=2
    )
    assert r.gap_open_cost == 2
    assert r.gap_open_score == -2


def test_sequence_content_rules():
    with pytest.raises(RuntimeError):
        validate_and_transform_args(seq_1="AC-T", seq_2="ACGT")
    with pytest.raises(RuntimeError):
        validate_and_transform_args(seq_1="", seq_2="ACGT")
    v = validate_and_transform_args(seq_1="acgt", seq_2="agt")
    assert v.seq_1 == "ACGT" and v.seq_2 == "AGT"


def test_length_cap_override():
    with pytest.raises(RuntimeError):
        validate_and_transform_args(
            seq_1="ACGT", seq_2="AGT", max_seq_len_prod=10
        )


def test_output_path_rules(tmp_path):
    existing = tmp_path / "out.txt"
    existing.write_text("x")
    with pytest.raises(RuntimeWarning):
        validate_and_transform_args(seq_1="AC", seq_2="AC", output=existing)
    with pytest.raises(FileNotFoundError):
        validate_and_transform_args(
            seq_1="AC", seq_2="AC", output=tmp_path / "nodir" / "out.txt"
        )
    v = validate_and_transform_args(
        seq_1="AC", seq_2="AC", output=tmp_path / "new.txt"
    )
    assert v.output == tmp_path / "new.txt"


def test_fasta_input(tmp_path):
    p = tmp_path / "in.fasta"
    p.write_text(">a\nACGT\n>b\nAGT\n")
    r = find_global_alignment(input_fasta=p)
    assert (r.score, r.cost) == (0, 7)


def test_missing_fasta():
    with pytest.raises(FileNotFoundError):
        validate_and_transform_args(input_fasta="/nonexistent/file.fa")


def test_matrix_missing_letters():
    # Sequences containing letters absent from the matrix must be rejected
    # (reference start.py:276-281).
    with pytest.raises(RuntimeError):
        find_global_alignment(
            seq_1="MKV1", seq_2="MKV", scoring_mat_name="BLOSUM62"
        )


def test_custom_matrix_checks(tmp_path):
    asym = tmp_path / "asym.mtx"
    asym.write_text("A C -\nA 2 -1 -2\nC -3 2 -2\n- -2 -2 2\n")
    with pytest.raises(RuntimeError, match="not symmetric"):
        find_global_alignment(seq_1="AC", seq_2="CA", scoring_mat_path=asym)

    small_diag = tmp_path / "smalldiag.mtx"
    small_diag.write_text("A C -\nA 2 9 -2\nC 9 2 -2\n- -2 -2 2\n")
    with pytest.raises(RuntimeError, match="main diagonal"):
        find_global_alignment(
            seq_1="AC", seq_2="CA", scoring_mat_path=small_diag
        )

    good = tmp_path / "good.mtx"
    good.write_text("A C -\nA 2 -1 -2\nC -1 2 -2\n- -2 -2 2\n")
    r = find_global_alignment(seq_1="AC", seq_2="CA", scoring_mat_path=good)
    assert r.cost >= 0
