"""Report rendering parity with the tutorial goldens (reference/tutorial.qmd:15-47)."""

import math

from globalign_jax import find_global_alignment, prettify_mat

TUTORIAL_GOLDEN = """seq_1
seq_2

ACGT
| ||
A-GT

score: 0
cost: 7
###########################################
# Settings
###########################################
scoring_mat:
    A  C  G  T  -
A   2 -3 -3 -3 -2
C  -3  2 -3 -3 -2
G  -3 -3  2 -3 -2
T  -3 -3 -3  2 -2
-  -2 -2 -2 -2  2

gap_open_score: -4

costing_mat:
   A C G T -
A  0 5 5 5 3
C  5 0 5 5 3
G  5 5 0 5 3
T  5 5 5 0 3
-  3 3 3 3 0

gap_open_cost: 4
"""


def test_tutorial_report_exact():
    r = find_global_alignment(seq_1="ACGT", seq_2="AGT")
    assert str(r) == TUTORIAL_GOLDEN


def test_write_to_file(tmp_path):
    out = tmp_path / "aln.txt"
    r = find_global_alignment(seq_1="ACGT", seq_2="AGT", output=out)
    r.write()
    assert out.read_text() == TUTORIAL_GOLDEN


def test_write_file_override(tmp_path):
    r = find_global_alignment(seq_1="ACGT", seq_2="AGT")
    out = tmp_path / "explicit.txt"
    r.write(file=out)
    assert out.read_text() == TUTORIAL_GOLDEN


def test_line_wrapping():
    # A long alignment is wrapped into 70-char blocks (conclude.py:36-60).
    seq = "ACGT" * 50  # 200 chars
    r = find_global_alignment(seq_1=seq, seq_2=seq)
    text = str(r)
    blocks = text.split("\n\n")
    # desc block + ceil(200/70)=3 triplet blocks + trailer
    assert len(blocks) >= 4
    body = blocks[1].split("\n")
    assert len(body[0]) == 70
    n_blocks = math.ceil(200 / 70)
    assert blocks[n_blocks].split("\n")[0] == seq[(n_blocks - 1) * 70 :]


def test_prettify_mat_widths():
    mat = {
        "A": {"A": 10, "B": -3},
        "B": {"A": -3, "B": 100},
    }
    s = prettify_mat(mat)
    lines = s.split("\n")
    assert lines[0] == "    A   B"
    assert lines[1] == "A  10  -3"
    assert lines[2] == "B  -3 100"


TUTORIAL_GOLDEN_2 = """seq_1
seq_2

CCTGAA
*|*| |
GCCG-A

score: -2
cost: 8
###########################################
# Settings
###########################################
scoring_mat:
    A  C  G  T  -
A   1 -1 -1 -1 -1
C  -1  1 -1 -1 -1
G  -1 -1  1 -1 -1
T  -1 -1 -1  1 -1
-  -1 -1 -1 -1  1

gap_open_score: -2

costing_mat:
   A C G T -
A  0 2 2 2 2
C  2 0 2 2 2
G  2 2 0 2 2
T  2 2 2 0 2
-  1 1 1 1 0

gap_open_cost: 2"""


def test_tutorial_python_api_report_exact():
    """Second reference-tutorial golden (reference tutorial.qmd:141-173),
    including the alignment strings (the deterministic tie-break coincides
    with the reference's choice here)."""
    from globalign_jax import find_global_alignment

    r = find_global_alignment(
        seq_1="CCTGAA",
        seq_2="GCCGA",
        match_score=1,
        mismatch_score=-1,
        gap_open_score=-2,
        gap_extension_score=-1,
    )
    assert str(r).strip() == TUTORIAL_GOLDEN_2.strip()


def test_cigar_emission():
    from globalign_jax import alignment_to_cigar, find_global_alignment

    r = find_global_alignment(seq_1="ACGT", seq_2="AGT")
    assert r.seq_1_aligned == "ACGT" and r.seq_2_aligned == "A-GT"
    assert r.cigar() == "1=1I2="
    assert r.cigar(extended=False) == "1M1I2M"
    assert alignment_to_cigar("AC--T", "A-GGT") == "1=1I2D1="
    import pytest as _pytest

    with _pytest.raises(ValueError):
        alignment_to_cigar("A-", "A-")
    with _pytest.raises(ValueError):
        alignment_to_cigar("AB", "A")
