"""Sequence-parallel (column-sharded) fill == single-device fill.

One pair's DP matrix is striped over the virtual 8-device CPU mesh with
pipelined wavefront + ppermute halo exchange (parallel/seqpar.py); the
final cost lanes must match the plain row fill exactly for any strip/block
geometry.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from globalign_jax.ops import fill_rows
from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
from globalign_jax.parallel.seqpar import make_strip_mesh, sharded_pair_cost
from globalign_jax.utils.matrices import create_scoring_mat, load_bundled_matrix
from globalign_jax.utils.tokenize import Alphabet, encode_padded


@pytest.fixture(scope="module")
def strip_mesh():
    return make_strip_mesh()


def _check(mesh, alpha, costing, s1, s2, block_rows, go=4):
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    ta = np.asarray(encode_padded(alpha, s1, len(s1)))
    tb = np.asarray(encode_padded(alpha, s2, len(s2)))
    want = np.asarray(
        fill_rows.row_fill(
            jnp.asarray(ta), jnp.asarray(tb), cm, gid, jnp.int32(go),
            want_moves=False,
        ).final3
    )
    got = sharded_pair_cost(
        mesh, ta, tb, costing.values, alpha.gap_id, go,
        block_rows=block_rows,
    )
    assert (want == got).all(), (s1, s2, block_rows, want, got)


@pytest.mark.parametrize("block_rows", [1, 3, 16, 64])
def test_seqpar_matches_single_device_dna(strip_mesh, block_rows):
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    rng = np.random.default_rng(block_rows)
    for _ in range(3):
        m = int(rng.integers(1, 90))
        n = int(rng.integers(8, 120))  # n >= D so every strip is nonempty
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        _check(strip_mesh, alpha, costing, s1, s2, block_rows)


def test_seqpar_matches_single_device_blosum(strip_mesh):
    scoring = load_bundled_matrix("BLOSUM62")
    costing = scoring_mat_to_costing_mat(
        scoring, max_score=int(scoring.values.max())
    )
    alpha = costing.alphabet
    letters = [c for c in alpha.letters if c != "-"]
    rng = np.random.default_rng(99)
    for _ in range(2):
        m = int(rng.integers(1, 70))
        n = int(rng.integers(8, 90))
        s1 = "".join(rng.choice(letters, m))
        s2 = "".join(rng.choice(letters, n))
        _check(strip_mesh, alpha, costing, s1, s2, block_rows=8)


def test_seqpar_gap_spanning_strips(strip_mesh):
    """A long horizontal gap run crossing several strip boundaries must be
    charged exactly one gap-open."""
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    s1 = "AC"
    s2 = "AC" + "G" * 60  # optimal path: 60-wide gap run across strips
    _check(strip_mesh, alpha, costing, s1, s2, block_rows=4)
    _check(strip_mesh, alpha, costing, s2, s1, block_rows=4)


def test_seqpar_short_seq2_guard(strip_mesh):
    """n < D must not produce zero-width strips (degenerate fallback)."""
    from globalign_jax.ops import fill_rows
    from globalign_jax.parallel.seqpar import sharded_pair_cost

    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    ta = jnp.asarray(encode_padded(alpha, "ACGTAC", 6))
    tb = jnp.asarray(encode_padded(alpha, "AGT", 3))  # n=3 < D=8
    want = np.asarray(
        fill_rows.row_fill(ta, tb, cm, gid, go, want_moves=False).final3
    )
    got = sharded_pair_cost(strip_mesh, ta, tb, cm, gid, go)
    assert (want == got).all()


def test_sharded_block_last_rows_matches_single_device(strip_mesh):
    """The checkpoint-pass primitive: a K-row block fill with INJECTED
    row-0/column-0 boundaries, column-sharded over the mesh, must
    reproduce the single-device block fill row bit-for-bit."""
    from globalign_jax.ops.fill_rows import row_fill
    from globalign_jax.ops.fill_scan import BIG, default_boundary
    from globalign_jax.parallel.seqpar import sharded_block_last_rows

    rng = np.random.default_rng(9)
    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    cm = jnp.asarray(costing.values)
    gid = jnp.int32(alpha.gap_id)
    go = jnp.int32(4)
    m, n, K = 21, 37, 8
    s1 = "".join(rng.choice(list("ACGT"), m))
    s2 = "".join(rng.choice(list("ACGT"), n))
    ta = np.asarray(encode_padded(alpha, s1, m))
    tb = np.asarray(encode_padded(alpha, s2, n))

    row0_g, col0_g = default_boundary(
        jnp.asarray(ta), jnp.asarray(tb), cm, gid, go
    )
    col0_np = np.asarray(col0_g)
    # Single-device truth, block by block.
    state = row0_g
    states = []
    for i0 in range(0, m, K):
        i1 = min(i0 + K, m)
        ta_blk = np.zeros((i1 - i0 + 1,), np.int32)
        ta_blk[1:] = ta[i0 + 1 : i1 + 1]
        col0y = jnp.asarray(col0_np[2, i0 : i1 + 1])
        state = row_fill(
            jnp.asarray(ta_blk), jnp.asarray(tb), cm, gid, go,
            row0=state, col0=jnp.stack([col0y, col0y, col0y]),
            want_moves=False,
        ).last3
        states.append(np.asarray(state))

    # Sharded blocks, chained through the same checkpoints.
    state_s = np.asarray(row0_g)
    for bi, i0 in enumerate(range(0, m, K)):
        i1 = min(i0 + K, m)
        ta_blk = np.zeros((i1 - i0 + 1,), np.int32)
        ta_blk[1:] = ta[i0 + 1 : i1 + 1]
        got = sharded_block_last_rows(
            strip_mesh, ta_blk, tb, costing.values, alpha.gap_id, 4,
            state_s, col0_np[:, i0 : i1 + 1], block_rows=3,
        )
        assert (got == states[bi]).all(), (bi, got, states[bi])
        state_s = got


def test_align_blocked_with_mesh_matches_unsharded(strip_mesh):
    """align_blocked(mesh=...) — the column-sharded checkpoint pass —
    must produce the identical alignment to the single-device path."""
    from globalign_jax.config import resolve_scheme
    from globalign_jax.ops.linear_tb import align_blocked

    rng = np.random.default_rng(31)
    s1 = "".join(rng.choice(list("ACGT"), 83))
    s2 = "".join(rng.choice(list("ACGT"), 61))
    scheme = resolve_scheme(s1, s2)
    ta = encode_padded(scheme.alphabet, s1, len(s1))
    tb = encode_padded(scheme.alphabet, s2, len(s2))

    kw = dict(block_rows=16)
    want = align_blocked(
        np.asarray(ta), jnp.asarray(tb), scheme.costing.values,
        scheme.alphabet.gap_id, scheme.gap_open_cost, s1, s2, **kw
    )
    got = align_blocked(
        np.asarray(ta), jnp.asarray(tb), scheme.costing.values,
        scheme.alphabet.gap_id, scheme.gap_open_cost, s1, s2,
        mesh=strip_mesh, **kw
    )
    assert (got.cost, got.seq_1_aligned, got.middle_part,
            got.seq_2_aligned) == (
        want.cost, want.seq_1_aligned, want.middle_part,
        want.seq_2_aligned
    )
