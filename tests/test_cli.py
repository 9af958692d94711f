"""CLI surface parity (reference globaligner.py:23-129)."""

import pytest

from globalign_jax.cli import build_parser, main


def test_parser_has_all_13_options():
    parser = build_parser()
    opts = {a.dest for a in parser._actions}
    assert {
        "input_fasta",
        "output",
        "seq_1",
        "seq_2",
        "scoring_mat_name",
        "scoring_mat_path",
        "match_score",
        "mismatch_score",
        "mismatch_cost",
        "gap_open_score",
        "gap_open_cost",
        "gap_extension_score",
        "gap_extension_cost",
    } <= opts


def test_cli_stdout(capsys):
    assert main(["--seq_1", "ACGT", "--seq_2", "AGT"]) == 0
    out = capsys.readouterr().out
    assert "score: 0" in out
    assert "cost: 7" in out
    assert "ACGT" in out


def test_cli_output_file(tmp_path):
    out = tmp_path / "result.txt"
    assert main(["--seq_1", "ACGT", "--seq_2", "AGT", "-o", str(out)]) == 0
    text = out.read_text()
    assert "score: 0" in text


def test_cli_scoring_mat_choices():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--scoring_mat_name", "PAM250"])


def test_cli_fasta(tmp_path, capsys):
    p = tmp_path / "in.fa"
    p.write_text(">a\nACGT\n>b\nAGT\n")
    assert main(["-i", str(p)]) == 0
    assert "cost: 7" in capsys.readouterr().out


def test_cli_version(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
