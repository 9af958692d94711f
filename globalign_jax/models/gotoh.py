"""GotohAligner — the flagship alignment model.

Orchestrates the device pipeline for one pair (the role of the
reference's ``find_global_alignment`` core,
src/globalign/globaligner.py:132-314):

    tokenize -> device fill (ops.fill_rows, the XLA row scan)
             -> host traceback over move codes (ops.traceback), switching to
                the checkpointed linear-space replay (ops.linear_tb) past a
                memory threshold
             -> final cost->score transform (ops.transforms)

plus cost-only and planes-debug entry points used by the batch engine, the
benchmarks, and the tests.

Full alignments materialize the O(m*n) move matrix while it is under
``moves_budget_bytes``, and use the blocked checkpoint+replay beyond it —
which is what removes the reference's m*n < 2e7 input cap (reference
start.py:213).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ResolvedScheme
from ..ops import fill_rows
from ..ops.linear_tb import align_blocked
from ..ops.traceback import Traceback, traceback_moves
from ..ops.transforms import final_cost_to_score
from ..utils.tokenize import encode_padded

# Above this many bytes of move codes, align() switches to the blocked
# linear-space traceback (64 MB ~ 8k x 8k pairs).  The default bounds
# BOTH the device buffer and the host fetch of the move plane; raise it
# per-aligner (moves_budget_bytes=...) or process-wide via
# GLOBALIGN_MOVES_BUDGET_BYTES.
import os as _os

DEFAULT_MOVES_BUDGET_BYTES = int(
    _os.environ.get("GLOBALIGN_MOVES_BUDGET_BYTES", 64 * 1024 * 1024)
)


@dataclass(frozen=True)
class GotohAlignment:
    seq_1_aligned: str
    middle_part: str
    seq_2_aligned: str
    cost: int
    score: int


class GotohAligner:
    """Affine-gap global aligner for a fixed resolved scheme.

    The scheme (alphabet + costing matrix + gap-open) is bound once; repeated
    ``align`` calls over same-shaped inputs reuse the jitted fill.
    """

    def __init__(
        self,
        scheme: ResolvedScheme,
        *,
        moves_budget_bytes: int = DEFAULT_MOVES_BUDGET_BYTES,
        pad_quantum: int = 256,
    ):
        from ..utils.platform import enable_compilation_cache

        enable_compilation_cache()
        self.scheme = scheme
        self.moves_budget_bytes = moves_budget_bytes
        # Sequences are padded up to this grid so distinct lengths reuse one
        # compiled fill (the fills take true lengths as traced m_true /
        # n_true); a fresh XLA compile costs seconds, padded cells cost
        # microseconds.
        self.pad_quantum = max(1, pad_quantum)
        self._cost_mat = jnp.asarray(scheme.costing.values, jnp.int32)
        self._gap_id = jnp.int32(scheme.alphabet.gap_id)
        self._gap_open = jnp.int32(scheme.gap_open_cost)

    # -- single pair ------------------------------------------------------

    def _pad_len(self, length: int) -> int:
        q = self.pad_quantum
        return max(q, q * -(-length // q))

    def _encode(self, seq_1: str, seq_2: str):
        a = self.scheme.alphabet
        tok_a = jnp.asarray(encode_padded(a, seq_1, self._pad_len(len(seq_1))))
        tok_b = jnp.asarray(encode_padded(a, seq_2, self._pad_len(len(seq_2))))
        return tok_a, tok_b

    def fill(self, seq_1: str, seq_2: str, *, want_moves=True, want_planes=False):
        tok_a, tok_b = self._encode(seq_1, seq_2)
        return fill_rows.row_fill(
            tok_a,
            tok_b,
            self._cost_mat,
            self._gap_id,
            self._gap_open,
            None,
            None,
            len(seq_1),
            len(seq_2),
            want_moves=want_moves,
            want_planes=want_planes,
        )

    def cost(self, seq_1: str, seq_2: str) -> int:
        """Optimal alignment cost only (O(m+n) device memory)."""
        with jax.named_scope("globalign.fill"):
            final3 = self.fill(seq_1, seq_2, want_moves=False).final3
        return int(np.min(np.asarray(final3)))

    def _moves_bytes(self, m: int, n: int) -> int:
        """Bytes of move codes the full-matrix path would materialize
        (the row scan's (m+1) x (padded n + 1) uint8 plane)."""
        return (m + 1) * (self._pad_len(n) + 1)

    def align(self, seq_1: str, seq_2: str) -> GotohAlignment:
        """Full alignment with deterministic traceback."""
        m, n = len(seq_1), len(seq_2)
        if self._moves_bytes(m, n) > self.moves_budget_bytes:
            tok_a, tok_b = self._encode(seq_1, seq_2)
            tb: Traceback = align_blocked(
                np.asarray(tok_a),
                tok_b,
                self._cost_mat,
                self._gap_id,
                self._gap_open,
                seq_1,
                seq_2,
            )
        else:
            with jax.named_scope("globalign.fill"):
                res = self.fill(seq_1, seq_2, want_moves=True)
            tb = traceback_moves(
                np.asarray(res.moves),
                seq_1,
                seq_2,
                np.asarray(res.final3),
                layout="row",
            )
        score = final_cost_to_score(
            cost=tb.cost,
            m=m,
            n=n,
            max_score=self.scheme.max_score,
        )
        return GotohAlignment(
            seq_1_aligned=tb.seq_1_aligned,
            middle_part=tb.middle_part,
            seq_2_aligned=tb.seq_2_aligned,
            cost=tb.cost,
            score=score,
        )

    def dp_planes(self, seq_1: str, seq_2: str) -> np.ndarray:
        """Dense (3, m+1, n+1) DP cost planes — test/debug oracle view."""
        res = self.fill(seq_1, seq_2, want_moves=False, want_planes=True)
        return np.asarray(res.planes)[:, : len(seq_1) + 1, : len(seq_2) + 1]
