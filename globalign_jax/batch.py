"""Batched many-pair alignment engine (length bucketing + vmap).

The reference aligns exactly one pair per process run
(src/globalign/globaligner.py:132-314).  On the device the economic unit
is a *batch*: thousands of independent pairs are padded into length
buckets, tokenized into dense int32 arrays, and filled by one vmapped
row scan per bucket (:func:`globalign_jax.ops.fill_rows.row_fill_batch`).
This module is the host-side front end for that engine:

  * bucketing policy (round lengths up to a quantum -> few recompiles,
    bounded pad waste; SURVEY.md §7 step 4),
  * scheme resolution over the union alphabet of the whole batch,
  * optional deterministic traceback per pair from the batched move codes,
  * optional data-parallel sharding over a device mesh
    (:mod:`globalign_jax.parallel.mesh`).

Results come back in input order, each with the same cost/score semantics as
the single-pair API (bit-identical to the reference's values).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from .config import ResolvedScheme, resolve_scheme
from .models.gotoh import GotohAlignment
from .ops import fill_rows
from .ops.traceback import traceback_moves
from .ops.transforms import final_cost_to_score
from .utils.tokenize import GAP, encode_padded

DEFAULT_BUCKET_QUANTUM = 32

# Above this many bytes of move codes for one bucket, traceback mode
# splits the bucket into sub-batches, and a pair whose own move matrix
# exceeds it takes the checkpointed linear-space replay.  Bounds the
# device buffer and the host fetch of the move planes; overridable
# process-wide via GLOBALIGN_BATCH_MOVES_BUDGET_BYTES.
import os as _os

DEFAULT_BATCH_MOVES_BUDGET = int(
    _os.environ.get(
        "GLOBALIGN_BATCH_MOVES_BUDGET_BYTES", 256 * 1024 * 1024
    )
)


@dataclass
class PendingAlignments:
    """A dispatched-but-unfetched :func:`align_pairs` call.

    Returned by ``align_pairs(..., flush=False)``: every cost-only
    bucket's fill has been DISPATCHED, but the one coalesced
    device->host fetch of their finals has not run yet.  ``resolve()``
    performs it and returns the final results.  The runner dispatches
    chunk k+1 before resolving chunk k, so the fetch of one chunk
    overlaps the fills of the next."""

    _flush: object

    def resolve(self) -> "list[PairResult]":
        return self._flush()


@dataclass(frozen=True)
class PairResult:
    """Result for one pair in a batch (traceback fields None in cost-only mode)."""

    cost: int
    score: int
    seq_1_aligned: str | None = None
    middle_part: str | None = None
    seq_2_aligned: str | None = None

    def cigar(self, extended: bool = True) -> str | None:
        """CIGAR of the alignment, or None in cost-only mode."""
        if self.seq_1_aligned is None:
            return None
        from .ops.traceback import alignment_to_cigar

        return alignment_to_cigar(
            self.seq_1_aligned, self.seq_2_aligned, extended=extended
        )


def bucket_length(length: int, quantum: int = DEFAULT_BUCKET_QUANTUM) -> int:
    """Round a sequence length up to the bucket grid (next multiple of quantum)."""
    return max(quantum, quantum * math.ceil(length / quantum))


def _validate_pairs(pairs: Sequence[tuple[str, str]]) -> list[tuple[str, str]]:
    out = []
    for idx, (s1, s2) in enumerate(pairs):
        if len(s1) == 0 or len(s2) == 0:
            raise RuntimeError(f"Pair {idx}: detected a sequence of length 0.")
        if GAP in s1 or GAP in s2:
            raise RuntimeError(
                f"Pair {idx}: sequences may not contain the '-' character."
            )
        out.append((s1.upper(), s2.upper()))
    return out


def align_pairs(
    pairs: Sequence[tuple[str, str]],
    *,
    scheme: ResolvedScheme | None = None,
    scoring_mat_name: str | None = None,
    scoring_mat_path=None,
    match_score=None,
    mismatch_score=None,
    mismatch_cost=None,
    gap_open_score=None,
    gap_open_cost=None,
    gap_extension_score=None,
    gap_extension_cost=None,
    with_traceback: bool = True,
    bucket_quantum: int = DEFAULT_BUCKET_QUANTUM,
    mesh=None,
    phase_seconds: dict | None = None,
    flush: bool = True,
) -> "list[PairResult] | PendingAlignments":
    """Align many independent pairs on device, in input order.

    Scheme options mirror :func:`globalign_jax.find_global_alignment`; a
    pre-resolved ``scheme`` may be passed instead.  With ``mesh`` set (a 1-D
    ``jax.sharding.Mesh``), each bucket's batch axis is sharded data-parallel
    across the mesh devices — cost-only and traceback modes both (moves
    stay sharded per device; final lanes are all-gathered).

    ``phase_seconds`` (optional dict) accumulates wall-clock per phase
    ("fill" = device DP fill, "fetch" = the coalesced cost-only
    device->host transfer, "traceback" = host string assembly,
    "blocked" = linear-space per-pair path) — the runner surfaces these
    in its structured stats; device phases are also annotated with
    ``jax.named_scope`` for jax.profiler traces.

    ``flush=False`` returns a :class:`PendingAlignments` whose
    ``resolve()`` runs the coalesced device fetch and final host
    assembly — the runner's chunk-pipelining hook.  Only cost-only
    buckets on one device defer; traceback buckets (whose host walk
    needs the move planes) and mesh-sharded buckets resolve eagerly.
    """
    import time as _time

    import jax as _jax

    def _phase(name):
        class _P:
            def __enter__(self):
                self._t0 = _time.perf_counter()
                self._scope = _jax.named_scope(f"globalign.{name}")
                self._scope.__enter__()
                return self

            def __exit__(self, *exc):
                self._scope.__exit__(*exc)
                if phase_seconds is not None:
                    phase_seconds[name] = phase_seconds.get(name, 0.0) + (
                        _time.perf_counter() - self._t0
                    )
                return False

        return _P()
    pairs = _validate_pairs(pairs)
    if not pairs:
        return []

    if scheme is None:
        # Union alphabet across the batch: for simple schemes the matrix
        # entries depend only on char-class (match/mismatch/gap), so a wider
        # alphabet leaves every pair's cost and score unchanged relative to
        # the reference's per-pair alphabet (start.py:355-358).
        all_1 = "".join(s1 for s1, _ in pairs)
        all_2 = "".join(s2 for _, s2 in pairs)
        scheme = resolve_scheme(
            all_1,
            all_2,
            scoring_mat_name=scoring_mat_name,
            scoring_mat_path=scoring_mat_path,
            match_score=match_score,
            mismatch_score=mismatch_score,
            mismatch_cost=mismatch_cost,
            gap_open_score=gap_open_score,
            gap_open_cost=gap_open_cost,
            gap_extension_score=gap_extension_score,
            gap_extension_cost=gap_extension_cost,
        )

    cost_mat = jnp.asarray(scheme.costing.values, jnp.int32)
    gap_id = jnp.int32(scheme.alphabet.gap_id)
    gap_open = jnp.int32(scheme.gap_open_cost)

    # Bucket by padded (M, N).
    buckets: dict[tuple[int, int], list[int]] = {}
    for idx, (s1, s2) in enumerate(pairs):
        key = (
            bucket_length(len(s1), bucket_quantum),
            bucket_length(len(s2), bucket_quantum),
        )
        buckets.setdefault(key, []).append(idx)

    results: list[PairResult | None] = [None] * len(pairs)
    # Cost-only device finals awaiting the one coalesced fetch at flush:
    # (device (B, 3) final lanes, pair indices) per bucket.
    deferred: list[tuple[jnp.ndarray, list[int]]] = []

    # Traceback mode materializes (M+1) x (N+1) move bytes per pair:
    # split buckets past the budget into sub-batches, and leave a bucket
    # whose single pair exceeds it whole for the linear-space path.
    bucket_items: list[tuple[tuple[int, int], list[int]]] = []
    for (M, N), indices in buckets.items():
        max_pairs = DEFAULT_BATCH_MOVES_BUDGET // ((M + 1) * (N + 1))
        if with_traceback and max_pairs >= 1:
            for lo in range(0, len(indices), max_pairs):
                bucket_items.append(((M, N), indices[lo : lo + max_pairs]))
        else:
            bucket_items.append(((M, N), indices))

    for (M, N), indices in bucket_items:
        if with_traceback and (M + 1) * (N + 1) > DEFAULT_BATCH_MOVES_BUDGET:
            # A single pair's move matrix exceeds the budget; use the
            # checkpointed linear-space traceback (same deterministic path).
            from .ops.linear_tb import align_blocked

            for idx in indices:
                s1, s2 = pairs[idx]
                tok_a = encode_padded(scheme.alphabet, s1, len(s1))
                tok_b = encode_padded(scheme.alphabet, s2, len(s2))
                with _phase("blocked"):
                    # A supplied mesh column-shards each block's
                    # checkpoint fill (parallel/seqpar.py).
                    tb = align_blocked(
                        tok_a, jnp.asarray(tok_b), cost_mat, gap_id,
                        gap_open, s1, s2, mesh=mesh,
                    )
                score = final_cost_to_score(
                    cost=tb.cost, m=len(s1), n=len(s2),
                    max_score=scheme.max_score,
                )
                results[idx] = PairResult(
                    cost=tb.cost,
                    score=score,
                    seq_1_aligned=tb.seq_1_aligned,
                    middle_part=tb.middle_part,
                    seq_2_aligned=tb.seq_2_aligned,
                )
            continue
        tok_a = np.stack(
            [encode_padded(scheme.alphabet, pairs[i][0], M) for i in indices]
        )
        tok_b = np.stack(
            [encode_padded(scheme.alphabet, pairs[i][1], N) for i in indices]
        )
        m_true = np.array([len(pairs[i][0]) for i in indices], np.int32)
        n_true = np.array([len(pairs[i][1]) for i in indices], np.int32)

        with _phase("fill"):
            if mesh is not None and with_traceback:
                from .parallel.mesh import sharded_fill_moves

                final3, moves = sharded_fill_moves(
                    mesh, tok_a, tok_b, cost_mat, gap_id, gap_open,
                    m_true, n_true,
                )
            elif mesh is not None:
                from .parallel.mesh import sharded_fill_costs

                final3 = sharded_fill_costs(
                    mesh, tok_a, tok_b, cost_mat, gap_id, gap_open,
                    m_true, n_true,
                )
            else:
                res = fill_rows.row_fill_batch(
                    jnp.asarray(tok_a),
                    jnp.asarray(tok_b),
                    cost_mat,
                    gap_id,
                    gap_open,
                    jnp.asarray(m_true),
                    jnp.asarray(n_true),
                    want_moves=with_traceback,
                )
                if not with_traceback:
                    deferred.append((res.final3, indices))
                    continue
                final3 = np.asarray(res.final3)
                moves = np.asarray(res.moves)

        for row, idx in enumerate(indices):
            s1, s2 = pairs[idx]
            cost = int(final3[row].min())
            score = final_cost_to_score(
                cost=cost, m=len(s1), n=len(s2), max_score=scheme.max_score
            )
            if with_traceback:
                with _phase("traceback"):
                    tb = traceback_moves(
                        moves[row], s1, s2, final3[row], layout="row"
                    )
                assert tb.cost == cost
                results[idx] = PairResult(
                    cost=cost,
                    score=score,
                    seq_1_aligned=tb.seq_1_aligned,
                    middle_part=tb.middle_part,
                    seq_2_aligned=tb.seq_2_aligned,
                )
            else:
                results[idx] = PairResult(cost=cost, score=score)

    def _flush() -> list[PairResult]:
        if deferred:
            _flush_deferred()
        return results  # type: ignore[return-value]

    def _flush_deferred() -> None:
        with _phase("fetch"):
            flat = np.asarray(
                jnp.concatenate([f for f, _ in deferred], axis=0)
            )
        row = 0
        for _, indices in deferred:
            for k, idx in enumerate(indices):
                s1, s2 = pairs[idx]
                cost = int(flat[row + k].min())
                score = final_cost_to_score(
                    cost=cost, m=len(s1), n=len(s2),
                    max_score=scheme.max_score,
                )
                results[idx] = PairResult(cost=cost, score=score)
            row += len(indices)

    if flush:
        return _flush()
    return PendingAlignments(_flush)


def alignment_to_pair_result(a: GotohAlignment) -> PairResult:
    return PairResult(
        cost=a.cost,
        score=a.score,
        seq_1_aligned=a.seq_1_aligned,
        middle_part=a.middle_part,
        seq_2_aligned=a.seq_2_aligned,
    )
