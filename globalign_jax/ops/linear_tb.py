"""Linear-space traceback: row checkpoints + block replay.

The reference keeps the full O(m*n) DP array alive for its traceback
(src/globalign/globaligner.py:756-821, :395-593), which is exactly why it
caps inputs at m*n < 2e7 (start.py:213).  This module removes the cap
(SURVEY.md §7 step 5, the "block-checkpoint + on-chip tile replay" variant):

1. **Checkpoint pass** — fill the DP in row blocks of ``block_rows`` rows,
   keeping only each block-boundary row's three lanes (3, n+1).  Device
   memory: O((m / K) * n) for checkpoints, O(n) working state.
2. **Replay pass** — walk the optimal path from (m, n) upward; for each
   block (visited last-to-first) re-fill just that block *with move codes*
   seeded from its checkpoint row and the global column-0 boundary, then
   continue the deterministic predecessor walk through it.  Device memory:
   O(K * n) for one block's moves at a time.

With K ~ sqrt(m) total memory is O(n * sqrt(m)) and total fill work is 2x
the plain fill — the standard checkpointing trade.  The traced path is
bit-identical to the full-matrix traceback (same move codes, same
deterministic tie priority M > Ix > Iy), which the test-suite asserts on
random pairs.  Both passes run the XLA row scan
(:func:`globalign_jax.ops.fill_rows.row_fill`) with the checkpoint row
and the global column-0 boundary injected.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from .fill_rows import row_fill
from .fill_scan import default_boundary
from .traceback import (
    GAP_CHAR,
    GAP_GLYPH,
    LEVEL_IX,
    LEVEL_M,
    MATCH_GLYPH,
    MISMATCH_GLYPH,
    Traceback,
)

DEFAULT_BLOCK_ROWS = 512

# Adaptive block sizing cap: each replay block materializes (K+1) x W move
# bytes on the device.  Growing K until the block move buffer hits this
# budget minimizes the number of blocks (fills and walk dispatches) at a
# bounded device-memory cost.
DEFAULT_BLOCK_MOVES_BYTES = 64 * 1024 * 1024

def _block_tokens(tok_a_ext: np.ndarray, i0: int, i1: int) -> jnp.ndarray:
    """1-origin token buffer for global rows i0+1..i1 (dummy entry 0)."""
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.asarray(tok_a_ext[i0 + 1 : i1 + 1])]
    )


def _block_col0(col0_np: np.ndarray, i0: int, i1: int) -> jnp.ndarray:
    """(3, K+1) column-0 boundary of global rows i0..i1 (the Iy lane of
    the global boundary in all three lanes, as row_fill reads it)."""
    col0y = jnp.asarray(col0_np[2, i0 : i1 + 1])
    return jnp.stack([col0y, col0y, col0y])


# Backward-walk move ops (the per-step OUTPUT of the device walk; the
# host rebuilds the aligned strings from these alone).
OP_DIAG = 0  # consume one char of each sequence
OP_LEFT = 1  # gap in seq_1 (consume seq_2[j-1])
OP_UP = 2  # gap in seq_2 (consume seq_1[i-1])


def _walk_block_impl(moves, j_entry, level_entry):
    """Walk one replay block's move codes ON DEVICE, bottom row to top.

    ``moves`` is the block's (K+1, W) row-major move plane.  The move
    matrices are O(K x n); the walk itself is a trivial serial
    recurrence, so it runs where the moves live: a ``lax.while_loop``
    from the block's bottom row to its top that records one op byte per
    step.  Only the O(K + n) op tape ever crosses to the host.

    Same level semantics as the full-matrix walker
    (ops/traceback.traceback_moves): code bits [0:2]=M, [2:4]=Ix,
    [4:6]=Iy predecessor levels; column 0 forces boundary up-moves
    without consuming a code (reference globaligner.py:562-581).

    Returns ``(ops, count, j_exit, level_exit)``; entry scalars may be
    device values, so chained block walks dispatch without host syncs.
    """
    K = moves.shape[0] - 1
    L = K + moves.shape[1]  # i decreases K times, j fewer than W

    def cond(st):
        return st[0] > 0

    def body(st):
        i_l, j, level, t, ops = st
        code = moves[i_l, j].astype(jnp.int32)
        boundary = j == 0
        is_m = level == 0
        is_x = level == 1
        op = jnp.where(
            boundary,
            OP_UP,
            jnp.where(is_m, OP_DIAG, jnp.where(is_x, OP_LEFT, OP_UP)),
        )
        nl = jnp.where(
            is_m, code & 3, jnp.where(is_x, (code >> 2) & 3, (code >> 4) & 3)
        )
        nl = jnp.where(boundary, level, nl)
        di = jnp.where(op == OP_LEFT, 0, 1)
        dj = jnp.where(op == OP_UP, 0, 1)
        ops = jax.lax.dynamic_update_index_in_dim(
            ops, op.astype(jnp.uint8), t, 0
        )
        return (i_l - di, j - dj, nl, t + 1, ops)

    _, j, level, t, ops = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.asarray(K, jnp.int32),
            jnp.asarray(j_entry, jnp.int32),
            jnp.asarray(level_entry, jnp.int32),
            jnp.int32(0),
            jnp.zeros((L,), jnp.uint8),
        ),
    )
    return ops, t, j, level


# Jitted entry point for the block-replay chain (one compile per
# block-shape class).
_walk_block = jax.jit(_walk_block_impl)


def align_blocked(
    tok_a_ext,
    tok_b_ext,
    cost_mat,
    gap_id,
    gap_open,
    seq_1: str,
    seq_2: str,
    *,
    block_rows: int | None = None,
    mesh=None,
) -> Traceback:
    """Full alignment with O(n * (m/K + K)) memory (see module docstring).

    Args:
        tok_a_ext / tok_b_ext: (m+1,) / (n+1,) int32 1-origin tokens; any
            padding past the true sequence lengths (taken from seq_1/seq_2)
            is ignored.
        cost_mat / gap_id / gap_open: the costing scheme.
        seq_1 / seq_2: the original strings (for emitting aligned text).
        block_rows: checkpoint interval K; default adaptive — grow blocks
            until one block's move buffer reaches
            ``DEFAULT_BLOCK_MOVES_BYTES`` (fewer blocks = fewer fills
            and walk dispatches).
        mesh: optional multi-device ``jax.sharding.Mesh`` — the
            CHECKPOINT pass then column-shards every block fill across
            the mesh's devices (parallel/seqpar.py pipeline; SURVEY.md
            §5 long-context row), so the O(m*n) fill work of a huge
            pair scales with device count.  The replay pass (move
            emission + walk of one K-row block at a time) stays on one
            device — it is O(K*n) per block and latency-bound.
    """
    m = len(seq_1)
    n = len(seq_2)
    tok_a_np = np.asarray(tok_a_ext)[: m + 1]
    # seq_2 is padded up to a 256 grid so differently-sized inputs reuse the
    # same compiled block fills (padded columns never feed real cells; the
    # result is read at column n).
    nq = max(256, 256 * -(-(n + 1) // 256)) - 1
    if block_rows is None:
        block_rows = max(
            DEFAULT_BLOCK_ROWS,
            min(m, DEFAULT_BLOCK_MOVES_BYTES // (nq + 1)),
        )
    K = max(1, block_rows)
    tok_b_np = np.zeros((nq + 1,), np.int32)
    tok_b_np[: n + 1] = np.asarray(tok_b_ext)[: n + 1]

    cost_mat = jnp.asarray(cost_mat, jnp.int32)
    gap_id = jnp.asarray(gap_id, jnp.int32)
    gap_open = jnp.asarray(gap_open, jnp.int32)
    tok_b = jnp.asarray(tok_b_np)

    row0_g, col0_g = default_boundary(
        jnp.asarray(tok_a_np), tok_b, cost_mat, gap_id, gap_open
    )
    col0_np = np.asarray(col0_g)

    # ---- checkpoint pass -------------------------------------------------
    bounds = list(range(0, m, K)) + [m]  # block b covers rows bounds[b]..[b+1]
    nblocks = len(bounds) - 1
    checkpoints: list[jnp.ndarray] = [row0_g]  # (3, n+1) at each bounds[b]
    state = row0_g
    seqpar_ctx = None
    if mesh is not None and mesh.devices.size > 1 and nq >= (
        mesh.devices.size
    ):
        # Column-sharded checkpoint fills: each block's O(K*n) fill work
        # spreads over the mesh, consecutive blocks chain through a
        # replicated DEVICE row (no per-block host round trips), and the
        # rows are bit-identical to the single-device backends.
        from ..parallel.seqpar import ShardedCheckpointFill

        seqpar_ctx = ShardedCheckpointFill(
            mesh, tok_b, cost_mat, gap_id, gap_open
        )
        state_full = seqpar_ctx.pad_row0(row0_g)
    for b in range(nblocks):
        i0, i1 = bounds[b], bounds[b + 1]
        ta_blk = _block_tokens(tok_a_np, i0, i1)
        if seqpar_ctx is not None:
            state_full = seqpar_ctx.block_last_rows(
                ta_blk, state_full, col0_np[:, i0 : i1 + 1]
            )
            state = state_full[:, : nq + 1]
            checkpoints.append(state)
            continue
        state = row_fill(
            ta_blk,
            tok_b,
            cost_mat,
            gap_id,
            gap_open,
            row0=state,
            col0=_block_col0(col0_np, i0, i1),
            want_moves=False,
        ).last3
        checkpoints.append(state)

    if seqpar_ctx is not None and jax.process_count() > 1:
        # On a multi-process (global) mesh the checkpoint rows live as
        # fully-REPLICATED global arrays; the replay pass below runs
        # process-local jits, which cannot consume cross-process arrays.
        # Localize once per checkpoint (every process holds a complete
        # copy, so the read is collective-free).
        checkpoints = [jnp.asarray(np.asarray(c)) for c in checkpoints]
        state = checkpoints[-1]

    final3 = np.asarray(state[:, n])
    cost = int(final3.min())

    # ---- replay pass -----------------------------------------------------
    # Each block is re-filled WITH move codes, then walked ON DEVICE
    # (_walk_block); consecutive walks chain through device scalars, so
    # the whole replay dispatches without a host sync and the only host
    # traffic is the final O(m + n) op tapes.
    j_dev = jnp.int32(n)
    level_dev = jnp.int32(int(final3.argmin()))
    tapes = []  # (ops, count) per block, walk order (bottom block first)
    for b in range(nblocks - 1, -1, -1):
        i0, i1 = bounds[b], bounds[b + 1]
        ta_blk = _block_tokens(tok_a_np, i0, i1)
        moves_blk = row_fill(
            ta_blk,
            tok_b,
            cost_mat,
            gap_id,
            gap_open,
            row0=checkpoints[b],
            col0=_block_col0(col0_np, i0, i1),
            want_moves=True,
        ).moves
        ops, count, j_dev, level_dev = _walk_block(moves_blk, j_dev, level_dev)
        tapes.append((ops, count))

    # One sync: start every tape's host copy, then materialize them all.
    for ops, count in tapes:
        try:
            ops.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without async copy
            pass
    tapes_np = [
        np.asarray(ops)[: int(np.asarray(count))] for ops, count in tapes
    ]

    # ---- host assembly from the op tapes --------------------------------
    s1a, midl, s2a = assemble_from_tapes(tapes_np, seq_1, seq_2)
    return Traceback(s1a, midl, s2a, cost)


def assemble_from_tapes(
    tapes_np, seq_1: str, seq_2: str
) -> tuple[str, str, str]:
    """Aligned strings from device-walked op tapes (walk order: from
    (m, n) upward; any trailing row-0 LEFT moves are implicit —
    reference globaligner.py:542-561)."""
    out_1: list[str] = []
    mid: list[str] = []
    out_2: list[str] = []
    i, j = len(seq_1), len(seq_2)
    for ops_np in tapes_np:
        for op in ops_np:
            if op == OP_DIAG:
                a, bch = seq_1[i - 1], seq_2[j - 1]
                out_1.append(a)
                mid.append(MATCH_GLYPH if a == bch else MISMATCH_GLYPH)
                out_2.append(bch)
                i -= 1
                j -= 1
            elif op == OP_LEFT:
                out_1.append(GAP_CHAR)
                mid.append(GAP_GLYPH)
                out_2.append(seq_2[j - 1])
                j -= 1
            else:
                out_1.append(seq_1[i - 1])
                mid.append(GAP_GLYPH)
                out_2.append(GAP_CHAR)
                i -= 1

    # Row 0: only horizontal moves remain (globaligner.py:542-561).
    while j > 0:
        out_1.append(GAP_CHAR)
        mid.append(GAP_GLYPH)
        out_2.append(seq_2[j - 1])
        j -= 1

    out_1.reverse()
    mid.reverse()
    out_2.reverse()
    return "".join(out_1), "".join(mid), "".join(out_2)
