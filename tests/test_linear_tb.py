"""Checkpoint + block-replay traceback == full-matrix traceback, bit for bit.

This is the engine's linear-space mode (ops/linear_tb.py) that removes the
reference's m*n < 2e7 input cap (reference start.py:213).  Identity with the
full traceback (same moves, same deterministic tie order) is the whole
correctness contract; block size must not matter.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from globalign_jax.ops import fill_rows, linear_tb
from globalign_jax.ops.traceback import alignment_cost, traceback_moves
from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
from globalign_jax.utils.matrices import create_scoring_mat, load_bundled_matrix
from globalign_jax.utils.tokenize import Alphabet, encode_padded


def _full_tb(ta, tb, cm, gid, go, s1, s2):
    r = fill_rows.row_fill(ta, tb, cm, gid, go, want_moves=True)
    return traceback_moves(
        np.asarray(r.moves), s1, s2, np.asarray(r.final3), "row"
    )


@pytest.mark.parametrize("block_rows", [1, 3, 16, 64, 1000])
def test_blocked_equals_full_dna(block_rows):
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    rng = np.random.default_rng(block_rows)
    for _ in range(4):
        m = int(rng.integers(1, 120))
        n = int(rng.integers(1, 120))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        ta = jnp.asarray(encode_padded(alpha, s1, m))
        tb = jnp.asarray(encode_padded(alpha, s2, n))
        t_full = _full_tb(ta, tb, cm, gid, go, s1, s2)
        t_blk = linear_tb.align_blocked(
            np.asarray(ta), tb, cm, gid, go, s1, s2,
            block_rows=block_rows,
        )
        assert t_full == t_blk
        # traced path re-prices to the fill's optimal cost
        assert (
            alignment_cost(
                t_blk.seq_1_aligned, t_blk.seq_2_aligned, costing, 4
            )
            == t_blk.cost
        )


def test_blocked_equals_full_blosum62():
    scoring = load_bundled_matrix("BLOSUM62")
    costing = scoring_mat_to_costing_mat(
        scoring, max_score=int(scoring.values.max())
    )
    alpha = costing.alphabet
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    letters = [c for c in alpha.letters if c != "-"]
    rng = np.random.default_rng(42)
    for _ in range(4):
        m = int(rng.integers(1, 100))
        n = int(rng.integers(1, 100))
        s1 = "".join(rng.choice(letters, m))
        s2 = "".join(rng.choice(letters, n))
        ta = jnp.asarray(encode_padded(alpha, s1, m))
        tb = jnp.asarray(encode_padded(alpha, s2, n))
        t_full = _full_tb(ta, tb, cm, gid, go, s1, s2)
        t_blk = linear_tb.align_blocked(
            np.asarray(ta), tb, cm, gid, go, s1, s2,
            block_rows=13,
        )
        assert t_full == t_blk


def test_aligner_switches_to_blocked_past_budget():
    """GotohAligner with a tiny moves budget must still produce the same
    alignment as with an unlimited one."""
    from globalign_jax.config import resolve_scheme
    from globalign_jax.models.gotoh import GotohAligner

    rng = np.random.default_rng(9)
    s1 = "".join(rng.choice(list("ACGT"), 150))
    s2 = "".join(rng.choice(list("ACGT"), 140))
    scheme = resolve_scheme(s1, s2)
    big = GotohAligner(scheme)
    small = GotohAligner(scheme, moves_budget_bytes=64)
    a1 = big.align(s1, s2)
    a2 = small.align(s1, s2)
    assert a1 == a2


def test_aligner_pad_quantum_invariant():
    """Shape-bucket padding must not change any result field."""
    from globalign_jax.config import resolve_scheme
    from globalign_jax.models.gotoh import GotohAligner

    rng = np.random.default_rng(77)
    s1 = "".join(rng.choice(list("ACGT"), 37))
    s2 = "".join(rng.choice(list("ACGT"), 61))
    scheme = resolve_scheme(s1, s2)
    exact = GotohAligner(scheme, pad_quantum=1)
    padded = GotohAligner(scheme, pad_quantum=64)
    assert exact.align(s1, s2) == padded.align(s1, s2)
    assert exact.cost(s1, s2) == padded.cost(s1, s2)
    assert (exact.dp_planes(s1, s2) == padded.dp_planes(s1, s2)).all()


def test_device_walk_matches_host_walker():
    """_walk_block's op tape over a full move matrix reproduces the host
    walker's move sequence exactly (minus the row-0 tail it leaves to the
    caller), for random pairs and levels."""
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    rng = np.random.default_rng(11)
    for _ in range(5):
        m = int(rng.integers(1, 60))
        n = int(rng.integers(1, 60))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        ta = jnp.asarray(encode_padded(alpha, s1, m))
        tb = jnp.asarray(encode_padded(alpha, s2, n))
        r = fill_rows.row_fill(ta, tb, cm, gid, go, want_moves=True)
        t_full = traceback_moves(
            np.asarray(r.moves), s1, s2, np.asarray(r.final3), "row"
        )
        level0 = int(np.asarray(r.final3).argmin())
        ops, count, j_exit, _ = linear_tb._walk_block(
            jnp.asarray(r.moves), jnp.int32(n), jnp.int32(level0)
        )
        ops_np = np.asarray(ops)[: int(count)]
        # Expected ops: walk order (bottom-up) = reversed aligned columns,
        # truncated before the row-0 horizontal tail.
        exp = []
        for a, b in zip(t_full.seq_1_aligned, t_full.seq_2_aligned):
            if a != "-" and b != "-":
                exp.append(linear_tb.OP_DIAG)
            elif a == "-":
                exp.append(linear_tb.OP_LEFT)
            else:
                exp.append(linear_tb.OP_UP)
        exp.reverse()
        # The device walk stops at i == 0, leaving j_exit row-0 LEFT moves
        # (the caller's row-0 tail) out of the tape.
        j_exit = int(np.asarray(j_exit))
        assert all(op == linear_tb.OP_LEFT for op in exp[len(exp) - j_exit:])
        assert ops_np.tolist() == exp[: len(exp) - j_exit]
