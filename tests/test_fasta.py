"""FASTA reader behavior (reference start.py:614-688)."""

import pytest

from globalign_jax import read_first_2_seqs_from_fasta, read_seq_from_fasta
from globalign_jax.utils.fasta import iter_fasta_pairs


def write(tmp_path, text):
    p = tmp_path / "in.fasta"
    p.write_text(text)
    return p


def test_multiline_and_upcase(tmp_path):
    p = write(tmp_path, ">first record\nacgt\nACGT\n\n>second\ntt\ngg\n")
    records = list(read_seq_from_fasta(p))
    assert records == [(">first record", "ACGTACGT"), (">second", "TTGG")]


def test_first_two(tmp_path):
    p = write(tmp_path, ">a\nAC\n>b\nGT\n>c\nTT\n")
    assert read_first_2_seqs_from_fasta(p) == ("AC", "GT")


def test_missing_leading_gt(tmp_path):
    p = write(tmp_path, "ACGT\n>a\nAC\n")
    with pytest.raises(RuntimeError):
        list(read_seq_from_fasta(p))


def test_empty_sequence(tmp_path):
    p = write(tmp_path, ">a\n>b\nACGT\n")
    with pytest.raises(RuntimeError):
        list(read_seq_from_fasta(p))


def test_single_record_pair_error(tmp_path):
    p = write(tmp_path, ">a\nACGT\n")
    with pytest.raises(RuntimeError):
        read_first_2_seqs_from_fasta(p)


def test_iter_pairs(tmp_path):
    p = write(tmp_path, ">a\nAC\n>b\nGT\n>c\nTT\n>d\nAA\n")
    pairs = list(iter_fasta_pairs(p))
    assert len(pairs) == 2
    assert pairs[0] == ((">a", "AC"), (">b", "GT"))
    assert pairs[1] == ((">c", "TT"), (">d", "AA"))


def test_iter_pairs_odd_count(tmp_path):
    p = write(tmp_path, ">a\nAC\n>b\nGT\n>c\nTT\n")
    with pytest.raises(RuntimeError):
        list(iter_fasta_pairs(p))
