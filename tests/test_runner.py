"""Batch runner: chunking, resume manifest, metrics, CLI surface."""

import json

import numpy as np
import pytest

from globalign_jax.api import find_global_alignment
from globalign_jax.runner import (
    BatchRunner,
    RunStats,
    pairs_from_fasta,
    pairs_from_tsv,
)


def _random_pairs(n, seed=0, max_len=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, max_len))
        k = int(rng.integers(1, max_len))
        out.append(
            (
                "".join(rng.choice(list("ACGT"), m)),
                "".join(rng.choice(list("ACGT"), k)),
            )
        )
    return out


def _read_results(path):
    rows = {}
    for line in path.read_text().splitlines():
        parts = line.split("\t")
        rows[int(parts[0])] = (int(parts[1]), int(parts[2]))
    return rows


def test_runner_results_match_single_pair_api(tmp_path, capsys):
    pairs = _random_pairs(7, seed=1)
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    stats = BatchRunner(output=out, chunk_pairs=3, log=log).run(pairs)
    log.close()
    assert stats.pairs == 7 and stats.chunks == 3
    rows = _read_results(out)
    assert len(rows) == 7
    for idx, (s1, s2) in enumerate(pairs):
        ref = find_global_alignment(seq_1=s1, seq_2=s2)
        assert rows[idx] == (ref.cost, ref.score), (idx, s1, s2)


def test_runner_resume_skips_journaled_chunks(tmp_path):
    pairs = _random_pairs(10, seed=2)
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")

    # First run: only the first 2 chunks (simulated preemption by truncation).
    r1 = BatchRunner(output=out, chunk_pairs=4, log=log)
    r1.run(pairs[:8])  # chunks 0 and 1 complete
    n_lines_before = len(out.read_text().splitlines())
    assert n_lines_before == 8

    # Rerun over the full input: chunks 0/1 skipped, chunk 2 done.
    r2 = BatchRunner(output=out, chunk_pairs=4, log=log)
    stats = r2.run(pairs)
    log.close()
    assert stats.skipped_chunks == 2
    assert stats.chunks == 1
    rows = _read_results(out)
    assert len(rows) == 10  # no duplicates, all pairs present
    manifest = [
        json.loads(x)
        for x in (tmp_path / "res.tsv.manifest.jsonl").read_text().splitlines()
    ]
    assert sorted(m["chunk"] for m in manifest) == [0, 1, 2]


def test_runner_manifest_fingerprint_isolation(tmp_path):
    """Reusing an output produced under different options must error
    (mixing schemes in one output file is ill-defined; silently skipping
    or silently dropping the old rows would both lose data)."""
    pairs = _random_pairs(4, seed=3)
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    BatchRunner(
        output=out, chunk_pairs=4, log=log,
        scheme_kwargs={"mismatch_cost": 9},
    ).run(pairs)
    with pytest.raises(RuntimeError, match="different\\s+options"):
        BatchRunner(output=out, chunk_pairs=4, log=log).run(pairs)
    log.close()


def test_runner_traceback_mode(tmp_path):
    pairs = [("ACGT", "AGT"), ("AAAA", "AA")]
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    BatchRunner(output=out, chunk_pairs=8, with_traceback=True, log=log).run(
        pairs
    )
    log.close()
    line0 = out.read_text().splitlines()[0].split("\t")
    assert line0[:3] == ["0", "7", "0"]
    assert line0[3:] == ["ACGT", "| ||", "A-GT"]


def test_pairs_from_tsv_and_fasta(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n\nAA\tA\n")
    assert list(pairs_from_tsv(tsv)) == [("ACGT", "AGT"), ("AA", "A")]
    bad = tmp_path / "bad.tsv"
    bad.write_text("onlyone\n")
    with pytest.raises(RuntimeError):
        list(pairs_from_tsv(bad))

    fa = tmp_path / "p.fasta"
    fa.write_text(">a\nACGT\n>b\nAGT\n>c\nAA\n>d\nA\n")
    assert list(pairs_from_fasta(fa)) == [("ACGT", "AGT"), ("AA", "A")]


def test_batch_cli_end_to_end(tmp_path):
    from globalign_jax.batch_cli import main

    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\nGATTACA\tGCATGCT\n")
    out = tmp_path / "out.tsv"
    rc = main(
        [
            "--pairs_tsv",
            str(tsv),
            "-o",
            str(out),
            "--chunk_pairs",
            "1",
        ]
    )
    assert rc == 0
    rows = _read_results(out)
    assert rows[0] == (7, 0)
    # rerun resumes: no duplicate lines
    rc = main(["--pairs_tsv", str(tsv), "-o", str(out), "--chunk_pairs", "1"])
    assert rc == 0
    assert len(out.read_text().splitlines()) == 2


def test_stats_dict_sane():
    s = RunStats(pairs=10, chunks=2, true_cells=1000, padded_cells=2000,
                 seconds=0.5)
    d = s.as_dict()
    assert d["pad_waste"] == 0.5 and d["pairs_per_s"] == 20.0


def test_runner_tolerates_torn_manifest_line(tmp_path):
    """A preemption mid-journal-write leaves a torn JSON line; resume must
    treat it as incomplete work, not crash."""
    pairs = _random_pairs(6, seed=5)
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    r1 = BatchRunner(output=out, chunk_pairs=3, log=log)
    r1.run(pairs[:3])  # chunk 0 complete
    manifest = tmp_path / "res.tsv.manifest.jsonl"
    with manifest.open("a") as f:
        f.write('{"fingerprint": "abc", "chu')  # torn write
    stats = BatchRunner(output=out, chunk_pairs=3, log=log).run(pairs)
    log.close()
    assert stats.skipped_chunks == 1 and stats.chunks == 1
    assert len(_read_results(out)) == 6


def test_batch_cli_cigar_column(tmp_path):
    from globalign_jax.batch_cli import main

    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    out = tmp_path / "out.tsv"
    assert main(["--pairs_tsv", str(tsv), "-o", str(out), "--cigar"]) == 0
    cols = out.read_text().splitlines()[0].split("\t")
    assert cols[3:] == ["ACGT", "| ||", "A-GT", "1=1I2="]


def test_runner_late_chunk_new_character(tmp_path):
    """A letter first appearing in a late chunk must not crash the run
    (simple schemes re-resolve per chunk)."""
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    pairs = [("ACGT", "AGT"), ("ACGT", "ACG"), ("NACGT", "ACNGT")]
    stats = BatchRunner(output=out, chunk_pairs=2, log=log).run(pairs)
    log.close()
    assert stats.pairs == 3
    rows = _read_results(out)
    ref = find_global_alignment(seq_1="NACGT", seq_2="ACNGT")
    assert rows[2] == (ref.cost, ref.score)


def test_runner_lowercase_tsv_input(tmp_path):
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    BatchRunner(output=out, chunk_pairs=4, log=log).run(
        [("acgtacgt", "acgtcgt")]
    )
    log.close()
    ref = find_global_alignment(seq_1="ACGTACGT", seq_2="ACGTCGT")
    assert _read_results(out)[0] == (ref.cost, ref.score)


def test_runner_rejects_different_input_on_resume(tmp_path):
    """Resuming against a different input file must error, not silently
    skip (the journal records a per-chunk input digest)."""
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    BatchRunner(output=out, chunk_pairs=4, log=log).run(
        _random_pairs(4, seed=11)
    )
    with pytest.raises(RuntimeError, match="different input"):
        BatchRunner(output=out, chunk_pairs=4, log=log).run(
            _random_pairs(4, seed=12)
        )
    log.close()


def test_runner_unjournaled_rows_deduped_on_resume(tmp_path):
    """Rows appended by a run that died before journaling are dropped on
    resume instead of being duplicated."""
    pairs = _random_pairs(6, seed=13)
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    r1 = BatchRunner(output=out, chunk_pairs=3, log=log)
    r1.run(pairs[:3])  # chunk 0 journaled
    # Simulate a crash after appending chunk 1's rows but before journaling.
    with out.open("a") as f:
        f.write("3\t99\t99\n4\t99\t99\n5\t99\t99\n")
    stats = BatchRunner(output=out, chunk_pairs=3, log=log).run(pairs)
    log.close()
    assert stats.chunks == 1 and stats.skipped_chunks == 1
    rows = _read_results(out)
    assert len(rows) == 6
    ref = find_global_alignment(seq_1=pairs[3][0], seq_2=pairs[3][1])
    assert rows[3] == (ref.cost, ref.score)  # recomputed, not the 99s
    assert len(out.read_text().splitlines()) == 6  # no duplicates


def test_batch_cli_shard_cigar(tmp_path):
    """--shard now supports traceback/CIGAR mode (sharded moves path)."""
    from globalign_jax.batch_cli import main

    tsv = tmp_path / "p.tsv"
    tsv.write_text("ACGT\tAGT\n")
    out = tmp_path / "o.tsv"
    rc = main(["--pairs_tsv", str(tsv), "-o", str(out), "--shard", "--cigar"])
    assert rc == 0
    row = out.read_text().splitlines()[0].split("\t")
    # idx, cost, score, three alignment lines, cigar
    assert row[1] == "7" and row[2] == "0"
    assert row[6] == "1=1I2="


def test_runner_matrix_scheme_cached_resolution(tmp_path):
    """Matrix-based schemes (scoring_mat_name/path) resolve ONCE and the
    cached scheme serves every later chunk (the alphabet is fixed by
    the matrix, not the chunk's characters) — and the results match the
    single-pair API under the same scheme.  Guards the _chunk_scheme
    cached branch the simple-scheme tests never enter."""
    rng = np.random.default_rng(11)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [
        (
            "".join(rng.choice(letters, int(rng.integers(3, 18)))),
            "".join(rng.choice(letters, int(rng.integers(3, 18)))),
        )
        for _ in range(6)
    ]
    out = tmp_path / "res.tsv"
    log = open(tmp_path / "log", "w")
    import globalign_jax.runner as runner_mod

    calls = []
    orig = runner_mod.resolve_scheme

    def counting(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    runner_mod.resolve_scheme, saved = counting, runner_mod.resolve_scheme
    try:
        stats = BatchRunner(
            output=out, chunk_pairs=2, log=log,
            scheme_kwargs={"scoring_mat_name": "BLOSUM62"},
        ).run(pairs)
    finally:
        runner_mod.resolve_scheme = saved
        log.close()
    assert stats.pairs == 6 and stats.chunks == 3
    assert len(calls) == 1  # resolved once, cached across chunks
    rows = _read_results(out)
    for idx, (s1, s2) in enumerate(pairs):
        ref = find_global_alignment(
            seq_1=s1, seq_2=s2, scoring_mat_name="BLOSUM62"
        )
        assert rows[idx] == (ref.cost, ref.score), (idx, s1, s2)
