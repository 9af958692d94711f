"""The row-scan fill pinned bit for bit to the oracles over a case grid.

``fill_rows`` is the engine's only fill on every platform, so its
contract is checked directly against the anti-diagonal fill
(``ops/fill_scan.py``) and the textbook numpy fill (``tests/oracle.py``):
final lanes, dense planes, move codes (through identical tracebacks),
injected ``row0``/``col0`` block boundaries, and the linear-space
traceback built on them.  The grid covers jagged true lengths inside one
padded batch, lengths off the bucket quantum, 1-character sequences,
zero-length rows, several gap-open values, BLOSUM62 and BLOSUM50, an
odd-``b`` custom matrix (Δd ≠ Δi) and alphabets of 27-31 letters with
the gap symbol at any position.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from globalign_jax.ops import fill_rows, fill_scan, linear_tb
from globalign_jax.ops.traceback import alignment_cost, traceback_moves

from .oracle import oracle_fill
from .schemes import DNA, SCHEMES, scheme as _scheme


def _args(costing, go):
    return (
        jnp.asarray(costing.values),
        jnp.int32(costing.alphabet.gap_id),
        jnp.int32(go),
    )


def _batch(letters, costing, lens, M, N, seed):
    rng = np.random.default_rng(seed)
    B = len(lens)
    tok_a = np.zeros((B, M + 1), np.int32)
    tok_b = np.zeros((B, N + 1), np.int32)
    seqs = []
    for b, (m, n) in enumerate(lens):
        s1 = "".join(rng.choice(list(letters), m))
        s2 = "".join(rng.choice(list(letters), n))
        tok_a[b, 1 : m + 1] = costing.alphabet.encode(s1)
        tok_b[b, 1 : n + 1] = costing.alphabet.encode(s2)
        seqs.append((s1, s2))
    mt = np.array([m for m, _ in lens], np.int32)
    nt = np.array([n for _, n in lens], np.int32)
    return tok_a, tok_b, mt, nt, seqs


# Jagged true lengths in one padded (37, 45) batch: off the bucket
# quantum, 1-character rows and columns, and one pair filling the pad.
JAGGED = [(37, 45), (1, 19), (23, 1), (1, 1), (30, 8)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SCHEMES)
def test_row_fill_batch_jagged_matches_oracles(name, seed):
    letters, costing, go = _scheme(name)
    tok_a, tok_b, mt, nt, seqs = _batch(letters, costing, JAGGED, 37, 45, seed)
    args = (jnp.asarray(tok_a), jnp.asarray(tok_b), *_args(costing, go),
            jnp.asarray(mt), jnp.asarray(nt))
    rows = fill_rows.row_fill_batch(*args, want_moves=True)
    diag = fill_scan.wavefront_fill_batch(*args, want_moves=True)
    f3 = np.asarray(rows.final3)
    assert (f3 == np.asarray(diag.final3)).all()
    for b, (s1, s2) in enumerate(seqs):
        want = oracle_fill(s1, s2, costing, go)[:, len(s1), len(s2)]
        assert (f3[b] == want).all(), (b, f3[b], want)
        t_rows = traceback_moves(
            np.asarray(rows.moves[b]), s1, s2, f3[b], layout="row"
        )
        t_diag = traceback_moves(
            np.asarray(diag.moves[b]), s1, s2, f3[b], layout="diag"
        )
        assert t_rows == t_diag, b
        assert alignment_cost(
            t_rows.seq_1_aligned, t_rows.seq_2_aligned, costing, go
        ) == t_rows.cost


@pytest.mark.parametrize("name", SCHEMES)
def test_row_fill_planes_match_numpy_oracle(name):
    letters, costing, go = _scheme(name)
    rng = np.random.default_rng(len(name))
    s1 = "".join(rng.choice(list(letters), 17))
    s2 = "".join(rng.choice(list(letters), 22))
    res = fill_rows.row_fill(
        jnp.asarray(np.r_[0, costing.alphabet.encode(s1)].astype(np.int32)),
        jnp.asarray(np.r_[0, costing.alphabet.encode(s2)].astype(np.int32)),
        *_args(costing, go), want_moves=False, want_planes=True,
    )
    got = np.asarray(res.planes).astype(np.int64)
    want = oracle_fill(s1, s2, costing, go)
    finite = want < 10**8
    assert (got[finite] == want[finite]).all()
    assert (got[~finite] >= fill_scan.BIG).all()


@pytest.mark.parametrize("name", ["dna_default", "BLOSUM62"])
@pytest.mark.parametrize("s1,s2", [
    ("A", "C"), ("A", "A"), ("G", "ACGTTGCA"), ("TTGACCA", "C"),
])
def test_row_fill_single_characters(name, s1, s2):
    letters, costing, go = _scheme(name)
    tr = str.maketrans(DNA, letters[:4])
    s1, s2 = s1.translate(tr), s2.translate(tr)
    ta = jnp.asarray(np.r_[0, costing.alphabet.encode(s1)].astype(np.int32))
    tb = jnp.asarray(np.r_[0, costing.alphabet.encode(s2)].astype(np.int32))
    rows = fill_rows.row_fill(ta, tb, *_args(costing, go), want_moves=True)
    diag = fill_scan.wavefront_fill(ta, tb, *_args(costing, go))
    want = oracle_fill(s1, s2, costing, go)[:, len(s1), len(s2)]
    assert (np.asarray(rows.final3) == want).all()
    assert traceback_moves(
        np.asarray(rows.moves), s1, s2, np.asarray(rows.final3), "row"
    ) == traceback_moves(
        np.asarray(diag.moves), s1, s2, np.asarray(diag.final3), "diag"
    )


@pytest.mark.parametrize("mt,nt", [(0, 0), (0, 7), (6, 0)])
def test_row_fill_batch_zero_length_rows(mt, nt):
    """A pad row with a zero true length reads the boundary cell."""
    letters, costing, go = _scheme("dna_default")
    tok_a, tok_b, _, _, _ = _batch(letters, costing, [(6, 7)] * 2, 8, 9, 3)
    m_true = np.array([6, mt], np.int32)
    n_true = np.array([7, nt], np.int32)
    res = fill_rows.row_fill_batch(
        jnp.asarray(tok_a), jnp.asarray(tok_b), *_args(costing, go),
        jnp.asarray(m_true), jnp.asarray(n_true),
    )
    s1 = costing.alphabet.decode(tok_a[1, 1 : mt + 1])
    s2 = costing.alphabet.decode(tok_b[1, 1 : nt + 1])
    want = oracle_fill(s1, s2, costing, go)[:, mt, nt]
    got = np.asarray(res.final3)[1].astype(np.int64)
    finite = want < 10**8
    assert (got[finite] == want[finite]).all()
    assert (got[~finite] >= fill_scan.BIG).all()


@pytest.mark.parametrize("name", ["dna_default", "BLOSUM62", "alpha_29_0"])
@pytest.mark.parametrize("i0,i1", [(0, 13), (11, 30), (17, 24), (29, 30)])
def test_row_fill_boundary_injection(name, i0, i1):
    """A block fill seeded with a checkpoint row (``row0``) and the global
    column-0 boundary (``col0``) reproduces the full fill's rows and move
    codes inside the block — the linear-space traceback's primitive."""
    letters, costing, go = _scheme(name)
    tok_a, tok_b, *_ = _batch(letters, costing, [(30, 25)], 30, 25, 5)
    ta, tb = jnp.asarray(tok_a[0]), jnp.asarray(tok_b[0])
    full = fill_rows.row_fill(
        ta, tb, *_args(costing, go), want_moves=True, want_planes=True
    )
    planes = np.asarray(full.planes)
    _, col0_g = fill_scan.default_boundary(ta, tb, *_args(costing, go))
    ta_blk = np.zeros(i1 - i0 + 1, np.int32)
    ta_blk[1:] = tok_a[0, i0 + 1 : i1 + 1]
    blk = fill_rows.row_fill(
        jnp.asarray(ta_blk), tb, *_args(costing, go),
        row0=jnp.asarray(planes[:, i0, :]),
        col0=linear_tb._block_col0(np.asarray(col0_g), i0, i1),
        want_moves=True,
    )
    assert (np.asarray(blk.last3) == planes[:, i1, :]).all()
    assert (
        np.asarray(blk.moves)[1:, 1:]
        == np.asarray(full.moves)[i0 + 1 : i1 + 1, 1:]
    ).all()
    assert (np.asarray(blk.final3) == planes[:, i1, 25]).all()


@pytest.mark.parametrize("block_rows", [7, 32])
@pytest.mark.parametrize("name", [
    "dna_1_7_1", "BLOSUM50", "odd_b", "alpha_27_26",
])
def test_align_blocked_matches_full_traceback(name, block_rows):
    letters, costing, go = _scheme(name)
    tok_a, tok_b, _, _, ((s1, s2),) = _batch(
        letters, costing, [(61, 43)], 61, 43, block_rows
    )
    full = fill_rows.row_fill(
        jnp.asarray(tok_a[0]), jnp.asarray(tok_b[0]), *_args(costing, go)
    )
    want = traceback_moves(
        np.asarray(full.moves), s1, s2, np.asarray(full.final3), "row"
    )
    got = linear_tb.align_blocked(
        tok_a[0], jnp.asarray(tok_b[0]), *_args(costing, go), s1, s2,
        block_rows=block_rows,
    )
    assert got == want


def test_row_fill_one_compile_across_lengths():
    """Distinct true lengths on one padded buffer grid share a single
    compiled executable (the lengths are traced, not static)."""
    letters, costing, go = _scheme("dna_default")
    tok_a, tok_b, _, _, _ = _batch(letters, costing, [(50, 50)], 50, 50, 9)
    ta, tb = jnp.asarray(tok_a[0]), jnp.asarray(tok_b[0])
    jax.clear_caches()
    for m, n in [(50, 50), (13, 41), (1, 2)]:
        res = fill_rows.row_fill(
            ta, tb, *_args(costing, go), None, None, m, n, want_moves=False
        )
        s1 = costing.alphabet.decode(tok_a[0, 1 : m + 1])
        s2 = costing.alphabet.decode(tok_b[0, 1 : n + 1])
        want = oracle_fill(s1, s2, costing, go)[:, m, n]
        assert (np.asarray(res.final3) == want).all()
    assert fill_rows.row_fill._cache_size() == 1
