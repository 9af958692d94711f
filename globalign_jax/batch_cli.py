"""Batch command-line front end: ``python -m globalign_jax.batch_cli``.

The reference has no batch mode (one pair per process,
src/globalign/globaligner.py:23); this is the production front end for the
device engine: stream pairs from a file, align in resumable chunks, append
results to a TSV, journal completed chunks for preemption-safe resume
(see :mod:`globalign_jax.runner`).

Scheme options mirror the single-pair CLI; input is either a FASTA file of
consecutive record pairs or a two-column TSV of raw sequences.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpalign-batch",
        description=(
            "Align many sequence pairs on the GPU with length bucketing, "
            "resumable chunking, and throughput metrics."
        ),
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--pairs_fasta",
        help="FASTA file; consecutive records form pairs (1&2, 3&4, ...).",
    )
    src.add_argument(
        "--pairs_tsv", help="TSV file with 'seq1<TAB>seq2' per line."
    )
    parser.add_argument(
        "-o",
        "--output",
        required=True,
        help=(
            "Results TSV (appended): idx, cost, score, plus the three "
            "alignment lines with --with_traceback.  A manifest journal at "
            "<output>.manifest.jsonl makes reruns resume instead of redoing "
            "completed chunks."
        ),
    )
    parser.add_argument(
        "--with_traceback",
        action="store_true",
        help="Also emit the aligned strings (slower: move codes on device).",
    )
    parser.add_argument(
        "--cigar",
        action="store_true",
        help="Append a CIGAR column ('='/'X'/'I'/'D'); implies --with_traceback.",
    )
    parser.add_argument("--chunk_pairs", type=int, default=1024)
    parser.add_argument("--bucket_quantum", type=int, default=32)
    parser.add_argument(
        "--fresh",
        action="store_true",
        help="Ignore and truncate any existing output/manifest (no resume).",
    )
    parser.add_argument(
        "--shard",
        action="store_true",
        help=(
            "Shard each chunk's batch data-parallel over all local devices "
            "(cost AND traceback modes: final lanes are all-gathered, move "
            "matrices stay sharded per device)."
        ),
    )
    # Scheme options (same semantics as the single-pair CLI).
    parser.add_argument(
        "--scoring_mat_name", choices=["BLOSUM50", "BLOSUM62"]
    )
    parser.add_argument("--scoring_mat_path")
    parser.add_argument("--match_score")
    parser.add_argument("--mismatch_score")
    parser.add_argument("--mismatch_cost")
    parser.add_argument("--gap_open_score")
    parser.add_argument("--gap_open_cost")
    parser.add_argument("--gap_extension_score")
    parser.add_argument("--gap_extension_cost")
    parser.add_argument("--platform", choices=["cpu", "gpu"])
    # Multi-host execution: every process runs this CLI with the same
    # input and its own --process_id; chunks are dealt round-robin and
    # each process appends to its own output shard (<output>.part<k>).
    parser.add_argument(
        "--distributed",
        action="store_true",
        help=(
            "Initialize jax.distributed (multi-host run).  Start ONE "
            "process per host: it owns all of that host's GPUs (a second "
            "JAX process on a GPU that is already open fails for want of "
            "memory); add --shard to spread each chunk over them."
        ),
    )
    parser.add_argument(
        "--coordinator_address",
        help="host:port of process 0 (omit on clusters that auto-detect).",
    )
    parser.add_argument("--num_processes", type=int)
    parser.add_argument("--process_id", type=int)
    parser.add_argument(
        "--profile_dir",
        help="Capture a jax.profiler trace of the run into this directory.",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    process_id, num_processes = 0, 1
    if args.distributed:
        from .parallel.multihost import initialize

        process_id, num_processes = initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from .runner import BatchRunner, pairs_from_fasta, pairs_from_tsv

    scheme_keys = (
        "scoring_mat_name",
        "scoring_mat_path",
        "match_score",
        "mismatch_score",
        "mismatch_cost",
        "gap_open_score",
        "gap_open_cost",
        "gap_extension_score",
        "gap_extension_cost",
    )
    scheme_kwargs = {
        k: getattr(args, k) for k in scheme_keys if getattr(args, k) is not None
    }

    output = Path(args.output)
    if args.fresh:
        from .parallel.multihost import part_path

        part = part_path(output, process_id, num_processes)
        part.unlink(missing_ok=True)
        part.with_name(part.name + ".manifest.jsonl").unlink(missing_ok=True)

    mesh = None
    if args.shard:
        import jax

        from .parallel.mesh import make_pair_mesh

        # In a multi-host run each process shards over its LOCAL devices
        # (chunks are already dealt across processes; a global mesh would
        # require every process to issue the same program in lockstep).
        mesh = make_pair_mesh(
            jax.local_devices() if num_processes > 1 else None
        )

    runner = BatchRunner(
        output=output,
        scheme_kwargs=scheme_kwargs,
        chunk_pairs=args.chunk_pairs,
        bucket_quantum=args.bucket_quantum,
        with_traceback=args.with_traceback or args.cigar,
        emit_cigar=args.cigar,
        mesh=mesh,
        process_id=process_id,
        num_processes=num_processes,
    )
    pairs = (
        pairs_from_fasta(args.pairs_fasta)
        if args.pairs_fasta
        else pairs_from_tsv(args.pairs_tsv)
    )

    if args.profile_dir:
        import jax

        with jax.profiler.trace(args.profile_dir):
            runner.run(pairs)
    else:
        runner.run(pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
