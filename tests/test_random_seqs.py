"""Random-sequence tooling goldens (reference tests/start_test.py:68-178)."""

import pytest

from globalign_jax import draw_random_seq, draw_two_random_seqs


@pytest.mark.parametrize(
    "alphabet,min_len,max_len,seed,expected",
    [
        (["A", "C", "T", "G"], 7, 10, 19, "GTTCGCA"),
        (["A", "C", "T", "G"], 5, 8, 345, "AGACGAC"),
        ([""], 7, 10, 19, ""),
        (["the", "fat", "cat"], 7, 10, 19, "catfatfatfatcatthethe"),
    ],
)
def test_draw_random_seq_golden(alphabet, min_len, max_len, seed, expected):
    assert draw_random_seq(alphabet, min_len, max_len, seed) == expected


@pytest.mark.parametrize(
    "alphabet,min_len,max_len,seed,err",
    [
        ([], 7, 10, 19, IndexError),
        (54646, 7, 10, 19, TypeError),
        (["the", "fat", "cat", 9], 7, 10, 19, TypeError),
        ([1, 0], 20, 20, 19, TypeError),
        (["a", "b"], 7, 3, 19, ValueError),
        (["a", "b"], -7, -3, 19, ValueError),
    ],
)
def test_draw_random_seq_invalid(alphabet, min_len, max_len, seed, err):
    with pytest.raises(err):
        draw_random_seq(alphabet, min_len, max_len, seed)


def test_draw_two_random_seqs_properties():
    s1, s2 = draw_two_random_seqs(
        alphabet=["A", "C", "G", "T"],
        min_len_seq_1=20,
        max_len_seq_1=30,
        min_len_seq_2=20,
        max_len_seq_2=30,
        divergence=0.0,
        seed_1=1,
        seed_2=2,
    )
    assert set(s1) <= set("ACGT") and set(s2) <= set("ACGT")
    assert 20 <= len(s1) <= 30
    assert 20 <= len(s2) <= 30

    # Zero divergence with equal target length leaves seq_2 closely related;
    # high divergence produces a substantially edited copy.
    s1h, s2h = draw_two_random_seqs(
        alphabet=["A", "C", "G", "T"],
        min_len_seq_1=30,
        max_len_seq_1=30,
        min_len_seq_2=30,
        max_len_seq_2=30,
        divergence=1.0,
        seed_1=1,
        seed_2=2,
    )
    assert len(s2h) == 30
    assert s1h != s2h
