"""Matrix I/O, synthesis, and validation (reference start.py:378-497, 883-939)."""

import numpy as np
import pytest

from globalign_jax import (
    check_big_main_diag,
    check_symmetric,
    create_costing_mat,
    create_scoring_mat,
    get_max_val,
    load_bundled_matrix,
    read_scoring_mat,
    validate_scoring_mat_keys,
)
from globalign_jax.utils.tokenize import Alphabet


# -- check_symmetric: the reference's own parametrized cases
# (tests/start_test.py:6-65) --------------------------------------------------

@pytest.mark.parametrize(
    "mat,expected",
    [
        ({"a": {"a": 4, "b": 3}, "b": {"a": 3, "b": 4}}, True),
        (
            {
                "a": {"a": 4, "b": 3, "c": 0},
                "b": {"a": 3, "b": 4, "c": 7},
                "c": {"a": 0, "b": 7, "c": 1},
            },
            True,
        ),
        (
            {
                "a": {"a": 4, "b": 3, "c": 0},
                "b": {"a": 3, "b": 4, "c": 7},
                "c": {"a": 0, "b": 17, "c": 1},
            },
            False,
        ),
        (
            {
                "a": {"a": 4, "b": 3, "c": 0},
                "b": {"a": 3, "b": 4, "c": 7},
                "d": {"a": 0, "b": 7, "c": 1},
            },
            False,
        ),
    ],
)
def test_check_symmetric_valid(mat, expected):
    assert check_symmetric(mat) == expected


@pytest.mark.parametrize("bad", [0, None, [[1, 4], [4, 1]]])
def test_check_symmetric_invalid_raises(bad):
    with pytest.raises(AttributeError):
        check_symmetric(bad)


def test_bundled_matrices():
    b62 = load_bundled_matrix("BLOSUM62")
    assert b62.alphabet.size == 25
    assert b62.lookup("A", "A") == 4
    assert b62.lookup("W", "W") == 11
    assert b62.lookup("A", "-") == -4
    assert b62.lookup("-", "-") == 1
    assert check_symmetric(b62)
    assert get_max_val(b62) == 11

    b50 = load_bundled_matrix("BLOSUM50")
    assert b50.lookup("W", "W") == 15
    assert b50.lookup("A", "-") == -5
    assert check_symmetric(b50)

    nt = load_bundled_matrix("nucleotide")
    assert nt.alphabet.letters == ("A", "C", "G", "T", "-")
    assert nt.lookup("A", "A") == 1
    assert nt.lookup("A", "C") == -1
    assert nt.lookup("A", "-") == -2

    with pytest.raises(ValueError):
        load_bundled_matrix("PAM250")


def test_read_scoring_mat_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_scoring_mat(tmp_path / "missing.mtx")

    bad_header = tmp_path / "bad_header.mtx"
    bad_header.write_text("AB C\nAB 1 2\nC 2 1\n")
    with pytest.raises(RuntimeError):
        read_scoring_mat(bad_header)

    bad_rows = tmp_path / "bad_rows.mtx"
    bad_rows.write_text("A C\nC 1 2\nA 2 1\n")
    with pytest.raises(RuntimeError):
        read_scoring_mat(bad_rows)


def test_read_scoring_mat_roundtrip(tmp_path):
    p = tmp_path / "m.mtx"
    p.write_text("# comment line\n A C -\na 2 -1 -2\nC -1 2 -2\n- -2 -2 2\n")
    m = read_scoring_mat(p)
    assert m.alphabet.letters == ("A", "C", "-")
    assert m.lookup("A", "A") == 2
    assert m.lookup("A", "C") == -1
    assert m.lookup("-", "A") == -2


def test_create_matrices():
    alphabet = Alphabet.from_sequences("ACG", "T")
    sm = create_scoring_mat(alphabet, 2, -3, -2)
    assert sm.lookup("A", "A") == 2
    assert sm.lookup("A", "C") == -3
    assert sm.lookup("A", "-") == -2
    assert sm.lookup("-", "-") == 2  # diagonal wins (reference start.py:442)

    cm = create_costing_mat(alphabet, 5, 3)
    assert cm.lookup("A", "A") == 0
    assert cm.lookup("A", "C") == 5
    assert cm.lookup("-", "A") == 3
    assert cm.lookup("-", "-") == 0


def test_check_big_main_diag():
    assert check_big_main_diag({"a": {"a": 5, "b": 1}, "b": {"a": 1, "b": 5}})
    assert not check_big_main_diag(
        {"a": {"a": 5, "b": 9}, "b": {"a": 9, "b": 5}}
    )
    assert check_big_main_diag(load_bundled_matrix("BLOSUM62"))


def test_validate_scoring_mat_keys():
    validate_scoring_mat_keys({"A", "C", "-"}, ["A", "C"])
    with pytest.raises(RuntimeError):
        validate_scoring_mat_keys({"A", "C"}, ["A", "C"])  # missing gap
    with pytest.raises(RuntimeError):
        validate_scoring_mat_keys({"A", "-"}, ["A", "C"])


def test_nested_dict_round_trip():
    b62 = load_bundled_matrix("BLOSUM62")
    from globalign_jax import SubstitutionMatrix

    back = SubstitutionMatrix.from_nested_dict(b62.to_nested_dict())
    np.testing.assert_array_equal(back.values, b62.values)
    assert back.alphabet.letters == b62.alphabet.letters
