"""Multi-host execution tested without hardware: 2 OS processes x 4 virtual
CPU devices join one 8-device jax.distributed runtime (Gloo collectives
between the processes) and run the production batch path end-to-end —
host-sharded chunks, sharded fills, ``lax.all_gather`` result merge, and
per-process output shards (SURVEY.md §5 "Distributed communication
backend"; BASELINE.md 2+ hosts axis).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_runner_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(REPO / "tests" / "multihost_harness.py"),
                str(pid),
                str(port),
                str(tmp_path),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=REPO,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # Chunks dealt round-robin: 16 pairs / chunk_pairs 4 -> 4 chunks, 2 each.
    assert {o["chunks"] for o in outs} == {2}
    assert {o["pairs"] for o in outs} == {8}

    # Phase-3 huge-pair blocked alignment (checkpoint pass column-sharded
    # over the GLOBAL mesh): both processes computed — and already
    # asserted equal to the single-device path in-harness — one cost.
    assert len({o["blocked_pair_cost"] for o in outs}) == 1

    # Merge the per-process output shards and compare against the
    # single-process engine on the same pairs.
    rows = {}
    for o in outs:
        for line in Path(o["output"]).read_text().splitlines():
            idx, cost, score = line.split("\t")
            assert int(idx) not in rows  # shards are disjoint
            rows[int(idx)] = (int(cost), int(score))
    assert sorted(rows) == list(range(16))

    from tests.multihost_harness import _pairs
    from globalign_jax.batch import align_pairs

    want = align_pairs(_pairs(), with_traceback=False)
    for i, r in enumerate(want):
        assert rows[i] == (r.cost, r.score), i

    # Lockstep collective phase: both processes ran ONE global-mesh
    # program whose batch axis spanned the two of them; the all_gather
    # merge must hand every process the full, correct cost vector.
    for o in outs:
        assert o["global_costs"] == [r.cost for r in want]


def test_two_process_batch_cli_distributed(tmp_path):
    """The batch CLI's --distributed surface end-to-end: two processes,
    shared input, per-process output shards that merge into the
    single-process result."""
    from tests.multihost_harness import _pairs
    from globalign_jax.batch import align_pairs

    pairs = _pairs()
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    out = tmp_path / "out.tsv"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "globalign_jax.batch_cli",
                "--pairs_tsv", str(tsv), "-o", str(out),
                "--platform", "cpu", "--chunk_pairs", "4",
                "--distributed",
                "--coordinator_address", f"localhost:{port}",
                "--num_processes", "2", "--process_id", str(pid),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=REPO,
            env=env,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]

    rows = {}
    for k in (0, 1):
        part = out.with_name(out.name + f".part{k}")
        for line in part.read_text().splitlines():
            idx, cost, score = line.split("\t")
            rows[int(idx)] = (int(cost), int(score))
    want = align_pairs(pairs, with_traceback=False)
    assert sorted(rows) == list(range(16))
    for i, r in enumerate(want):
        assert rows[i] == (r.cost, r.score), i


def test_two_process_distributed_traceback(tmp_path):
    """--distributed WITH tracebacks: two processes produce per-shard
    alignment + CIGAR columns that match the single-process result
    exactly (deterministic tie order makes strings comparable)."""
    from tests.multihost_harness import _pairs
    from globalign_jax.batch import align_pairs

    pairs = _pairs()
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    out = tmp_path / "out.tsv"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "globalign_jax.batch_cli",
                "--pairs_tsv", str(tsv), "-o", str(out),
                "--platform", "cpu", "--chunk_pairs", "4",
                "--with_traceback", "--cigar",
                "--distributed",
                "--coordinator_address", f"localhost:{port}",
                "--num_processes", "2", "--process_id", str(pid),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=REPO,
            env=env,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]

    rows = {}
    for k in (0, 1):
        part = out.with_name(out.name + f".part{k}")
        for line in part.read_text().splitlines():
            fields = line.split("\t")
            rows[int(fields[0])] = fields[1:]
    want = align_pairs(pairs, with_traceback=True)
    assert sorted(rows) == list(range(len(pairs)))
    for i, r in enumerate(want):
        # Row: cost, score, aligned_1, middle, aligned_2, cigar.
        assert rows[i] == [
            str(r.cost), str(r.score),
            r.seq_1_aligned, r.middle_part, r.seq_2_aligned, r.cigar(),
        ], i
