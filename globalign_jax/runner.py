"""Resumable many-pair batch runner with throughput metrics.

The reference aligns one pair per process (src/globalign/globaligner.py:23);
production serving aligns millions.  This runner adds the two subsystems
SURVEY.md §5 calls out as absent from the reference and required here:

* **Job-level checkpoint/resume** — pairs are processed in fixed-size chunks;
  each completed chunk appends one JSON line to a manifest journal
  (``<output>.manifest.jsonl``) keyed by an input fingerprint.  A rerun after
  preemption replays the journal, skips completed chunks, and continues —
  results are append-only, so nothing is recomputed or duplicated.
* **Metrics/observability** — per-chunk structured stats on stderr (pairs/s,
  GCUPS over true cells, bucket pad-waste) and a run summary; the GCUPS
  numerator is the sum of true m*n per pair, not padded cells, so padding
  inefficiency shows up as lower GCUPS rather than being hidden.

The device work goes through :func:`globalign_jax.batch.align_pairs` (length
bucketing + the vmapped row-scan fill, optional mesh sharding).
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

from .batch import DEFAULT_BUCKET_QUANTUM, align_pairs, bucket_length
from .config import resolve_scheme

DEFAULT_CHUNK_PAIRS = 1024


@dataclass
class RunStats:
    pairs: int = 0
    chunks: int = 0
    skipped_chunks: int = 0
    true_cells: int = 0
    padded_cells: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        gcups = self.true_cells / self.seconds / 1e9 if self.seconds else 0.0
        return {
            "pairs": self.pairs,
            "chunks": self.chunks,
            "skipped_chunks": self.skipped_chunks,
            "gcups": round(gcups, 4),
            "pairs_per_s": round(self.pairs / self.seconds, 2)
            if self.seconds
            else 0.0,
            "pad_waste": round(1 - self.true_cells / self.padded_cells, 4)
            if self.padded_cells
            else 0.0,
            "seconds": round(self.seconds, 3),
        }


@dataclass
class BatchRunner:
    """Aligns a stream of pairs in resumable chunks.

    Args:
        output: results TSV path (appended; ``idx\\tcost\\tscore`` plus the
            three alignment lines in traceback mode).  Completed work is
            journaled to ``<output>.manifest.jsonl``.
        scheme_kwargs: forwarded to :func:`resolve_scheme` (same surface as
            find_global_alignment's scheme options).
        chunk_pairs: pairs per resumable chunk.
        with_traceback: also emit aligned strings (slower; moves on device).
        mesh: optional 1-D device mesh for data-parallel sharding (both
            cost-only and traceback modes; in a multi-host run pass a mesh
            over jax.local_devices() — chunks are already dealt across
            processes).
        log: file-like for structured stats lines (default stderr).
    """

    output: Path
    scheme_kwargs: dict = field(default_factory=dict)
    chunk_pairs: int = DEFAULT_CHUNK_PAIRS
    bucket_quantum: int = DEFAULT_BUCKET_QUANTUM
    with_traceback: bool = False
    emit_cigar: bool = False
    mesh: object = None
    log: object = None
    # Multi-host: this process aligns only chunks with
    # chunk_id % num_processes == process_id, into its own output shard
    # (<output>.part<k>) with its own manifest — see parallel.multihost.
    process_id: int = 0
    num_processes: int = 1

    def __post_init__(self):
        from .parallel.multihost import part_path

        self.output = part_path(
            self.output, self.process_id, self.num_processes
        )
        self.manifest_path = self.output.with_name(
            self.output.name + ".manifest.jsonl"
        )
        if self.log is None:
            self.log = sys.stderr

    # -- manifest ---------------------------------------------------------

    def _fingerprint(self) -> str:
        """Run identity: scheme + chunking; guards stale manifests."""
        basis = json.dumps(
            {
                "scheme": {
                    k: str(v) for k, v in sorted(self.scheme_kwargs.items())
                },
                "chunk_pairs": self.chunk_pairs,
                "bucket_quantum": self.bucket_quantum,
                "with_traceback": self.with_traceback,
                "emit_cigar": self.emit_cigar,
                # Chunk ownership changes with the process topology; a
                # resume under a different topology would silently drop
                # rows, so it is part of the run identity.
                "topology": [self.process_id, self.num_processes],
            },
            sort_keys=True,
        )
        return hashlib.sha256(basis.encode()).hexdigest()[:16]

    def _completed_chunks(self) -> dict[int, str]:
        """chunk id -> pairs digest of journaled (completed) chunks.

        Raises if the manifest holds entries from a run with DIFFERENT
        options: mixing outputs of different schemes/chunkings in one file
        is ill-defined, and resuming would otherwise silently drop the
        previous run's rows (the dedupe pass keeps only chunks journaled
        under the current fingerprint).
        """
        done: dict[int, str] = {}
        foreign: set[str] = set()
        fp = self._fingerprint()
        if not self.manifest_path.exists():
            return done
        with self.manifest_path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write from a preempted run
                if "chunk" not in rec:
                    continue
                if rec.get("fingerprint") == fp:
                    done[int(rec["chunk"])] = rec.get("pairs_sha", "")
                else:
                    foreign.add(str(rec.get("fingerprint")))
        if foreign:
            raise RuntimeError(
                f"Output {self.output} was produced by a run with different "
                f"options (manifest fingerprints {sorted(foreign)} != "
                f"{fp}).  Use a fresh output path or --fresh."
            )
        return done

    def _dedupe_output(self, done: dict[int, str]) -> None:
        """Drop output rows of chunks that were never journaled.

        Results are appended before the journal line (so a crash between
        the two leaves rows without a journal entry); on resume those rows
        would be recomputed and appended again.  Rewriting the output to
        keep only journaled chunks makes resume exactly-once.
        """
        if not self.output.exists():
            return

        # Stream line-by-line (outputs can be multi-GB at the runner's
        # million-pair scale — never load the file into memory), and only
        # rewrite at all when something must be dropped: the common clean
        # resume is one read pass, no tmp copy.
        def keep(line: str) -> bool:
            try:
                idx = int(line.split("\t", 1)[0])
            except (ValueError, IndexError):
                return False
            return idx // self.chunk_pairs in done

        with self.output.open() as src:
            if all(keep(line) for line in src):
                return

        tmp = self.output.with_suffix(self.output.suffix + ".tmp")
        with self.output.open() as src, tmp.open("w") as dst:
            for line in src:
                if keep(line):
                    dst.write(line if line.endswith("\n") else line + "\n")
        tmp.replace(self.output)

    @staticmethod
    def _pairs_digest(chunk) -> str:
        h = hashlib.sha256()
        for s1, s2 in chunk:
            h.update(s1.encode())
            h.update(b"\t")
            h.update(s2.encode())
            h.update(b"\n")
        return h.hexdigest()[:16]

    def _journal(
        self, chunk: int, n_pairs: int, seconds: float, pairs_sha: str
    ) -> None:
        rec = {
            "fingerprint": self._fingerprint(),
            "chunk": chunk,
            "pairs": n_pairs,
            "pairs_sha": pairs_sha,
            "seconds": round(seconds, 3),
            "ts": time.time(),
        }
        with self.manifest_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()

    # -- run --------------------------------------------------------------

    def _chunks(
        self, pairs: Iterable[tuple[str, str]]
    ) -> Iterator[tuple[int, int, list[tuple[str, str]]]]:
        """Yield (chunk_id, base_index, chunk_pairs)."""
        buf: list[tuple[str, str]] = []
        chunk_id = 0
        base = 0
        for p in pairs:
            buf.append(p)
            if len(buf) == self.chunk_pairs:
                yield chunk_id, base, buf
                base += len(buf)
                chunk_id += 1
                buf = []
        if buf:
            yield chunk_id, base, buf

    def _chunk_scheme(self, chunk, cached):
        """Scheme for a chunk.

        Matrix-based schemes (named/custom matrix) fix the alphabet and are
        resolved once; simple schemes are class-based (match/mismatch/gap —
        values independent of the alphabet), so each chunk resolves over its
        own upper-cased character union and a letter first appearing in a
        late chunk cannot crash the run.
        """
        matrix_based = any(
            self.scheme_kwargs.get(k)
            for k in ("scoring_mat_name", "scoring_mat_path")
        )
        if matrix_based and cached is not None:
            return cached
        all_1 = "".join(s1 for s1, _ in chunk).upper()
        all_2 = "".join(s2 for _, s2 in chunk).upper()
        return resolve_scheme(all_1, all_2, **self.scheme_kwargs)

    def run(self, pairs: Iterable[tuple[str, str]]) -> RunStats:
        """Align all pairs, resuming past journaled chunks; returns stats."""
        scheme = None
        stats = RunStats()
        done = self._completed_chunks()
        self._dedupe_output(done)
        # The dispatched-but-unresolved previous chunk (chunk pipeline).
        in_flight = None

        from .parallel.multihost import owns_chunk

        for chunk_id, base, chunk in self._chunks(pairs):
            if not owns_chunk(chunk_id, self.process_id, self.num_processes):
                continue
            sha = self._pairs_digest(chunk)
            prev = done.get(chunk_id)
            if prev is not None:
                if prev and prev != sha:
                    raise RuntimeError(
                        f"Chunk {chunk_id}: journaled input digest {prev} "
                        f"does not match this input ({sha}).  The manifest "
                        f"at {self.manifest_path} belongs to a different "
                        f"input file; use a fresh output path (or --fresh)."
                    )
                stats.skipped_chunks += 1
                continue
            scheme = self._chunk_scheme(chunk, scheme)
            phases: dict[str, float] = {}
            t0 = time.perf_counter()
            # One-deep chunk pipeline: dispatch this chunk's fills
            # (flush=False defers the coalesced device->host fetch),
            # then resolve + write + journal the PREVIOUS chunk while
            # this one computes.
            pending = align_pairs(
                chunk,
                scheme=scheme,
                with_traceback=self.with_traceback,
                bucket_quantum=self.bucket_quantum,
                mesh=self.mesh,
                phase_seconds=phases,
                flush=False,
            )
            dt = time.perf_counter() - t0
            if in_flight is not None:
                self._finish_chunk(stats, *in_flight)
            in_flight = (pending, chunk_id, base, chunk, sha, phases, dt)

        if in_flight is not None:
            self._finish_chunk(stats, *in_flight)

        print(json.dumps({"run": self._fingerprint(), **stats.as_dict()}),
              file=self.log)
        return stats

    def _finish_chunk(
        self, stats, pending, chunk_id, base, chunk, sha, phases, dt
    ) -> None:
        """Resolve a dispatched chunk: fetch, write rows, journal, log."""
        t0 = time.perf_counter()
        results = pending.resolve()
        dt += time.perf_counter() - t0

        with self.output.open("a") as out:
            for k, r in enumerate(results):
                row = [str(base + k), str(r.cost), str(r.score)]
                if self.with_traceback:
                    row += [
                        r.seq_1_aligned,
                        r.middle_part,
                        r.seq_2_aligned,
                    ]
                    if self.emit_cigar:
                        row.append(r.cigar())
                out.write("\t".join(row) + "\n")

        true_cells = sum(len(a) * len(b) for a, b in chunk)
        padded = sum(
            bucket_length(len(a), self.bucket_quantum)
            * bucket_length(len(b), self.bucket_quantum)
            for a, b in chunk
        )
        stats.pairs += len(chunk)
        stats.chunks += 1
        stats.true_cells += true_cells
        stats.padded_cells += padded
        stats.seconds += dt
        self._journal(chunk_id, len(chunk), dt, sha)
        print(
            json.dumps(
                {
                    "chunk": chunk_id,
                    "pairs": len(chunk),
                    "gcups": round(true_cells / dt / 1e9, 4),
                    "pairs_per_s": round(len(chunk) / dt, 2),
                    "pad_waste": round(1 - true_cells / padded, 4),
                    # Per-phase wall-clock (device fill vs host walk vs
                    # blocked checkpoint+replay) — SURVEY.md §5 row 1.
                    "phase_seconds": {
                        k: round(v, 4) for k, v in sorted(phases.items())
                    },
                }
            ),
            file=self.log,
        )


def pairs_from_fasta(path) -> Iterator[tuple[str, str]]:
    """Consecutive-record pairs from a FASTA file (streaming)."""
    from .utils.fasta import iter_fasta_pairs

    for (_, s1), (_, s2) in iter_fasta_pairs(path):
        yield (s1, s2)


def pairs_from_tsv(path) -> Iterator[tuple[str, str]]:
    """``seq1<TAB>seq2`` lines (streaming; blank lines skipped)."""
    with Path(path).open() as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                raise RuntimeError(
                    f"{path}:{ln}: expected 'seq1<TAB>seq2', got "
                    f"{len(parts)} fields"
                )
            yield (parts[0], parts[1])
