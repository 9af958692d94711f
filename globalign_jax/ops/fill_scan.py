"""Anti-diagonal (wavefront) Gotoh DP fill in pure JAX.

A vectorized re-design of the reference's interpreted hot loop
(src/globalign/globaligner.py:317-392 ``get_next_best_costs`` /
``dp_array_forward`` and the boundary init at :756-821), kept as the
engine's semantic oracle.

Design
------
The Gotoh three-level recurrence in **cost space** (minimize) is

    M [i,j] = min(M, Ix, Iy)[i-1,j-1]                      + sub(a_i, b_j)
    Ix[i,j] = min(M + go, Ix, Iy + go)[i,  j-1]            + dcost(b_j)
    Iy[i,j] = min(M + go, Ix + go, Iy)[i-1,j  ]            + icost(a_i)

where ``go`` is the gap-open *transition* penalty charged when entering level
Ix/Iy from a different level (reference globaligner.py:342-357 — note the
reference charges it even for one-gap runs), ``dcost(c) = cost('-', c)``
(horizontal step, gap in seq_1) and ``icost(c) = cost(c, '-')`` (vertical
step, gap in seq_2).

Cells on anti-diagonal ``k = i + j`` depend only on diagonals ``k-1`` and
``k-2`` (SURVEY.md §3.3), so the fill is a single ``lax.scan`` over diagonals
in which each step is a handful of vectorized min/adds
over ``(m+1,)`` int32 buffers (three DP levels, two trailing diagonals).  No
data-dependent Python control flow; all shapes static; boundary conditions are
injected with ``jnp.where`` masks instead of branches.

Alongside the three cost lanes the fill emits 2-bit **move codes** per lane
(argmin provenance, packed into one uint8 per cell) which the traceback
decodes in O(m+n) — replacing the reference's rank-dispatch traceback
(globaligner.py:395-685) with a deterministic predecessor walk.  Ties are
broken by the fixed level priority M < Ix < Iy (first minimum), making
alignments deterministic where the reference used unseeded ``random.choice``
(globaligner.py:598-672); cost and score are unaffected.

The returned diagonals are in "skewed" (diagonal-major) layout: entry
``[k, i]`` corresponds to DP cell ``(i, j=k-i)``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Large sentinel standing in for +inf, the array analog of the reference's
# ``big_num = (max_cost + 1) * max(m, n)`` trick (globaligner.py:774-777).
# Chosen so that BIG plus any accumulated step costs stays far below the
# int32 overflow point for any practical sequence length.
BIG = np.int32(1 << 30)


class FillResult(NamedTuple):
    """Result of a wavefront fill.

    Attributes:
        final3: (3,) int32 — (M, Ix, Iy) at cell (m, n); ``min(final3)`` is the
            optimal alignment cost (reference globaligner.py:425).
        moves: (m+n+1, m+1) uint8 diagonal-major packed argmin codes, or None.
            ``moves[k, i]`` belongs to cell (i, k-i); bits 0-1 = level-M
            predecessor, bits 2-3 = level-Ix, bits 4-5 = level-Iy
            (0=M, 1=Ix, 2=Iy).
        planes: (m+n+1, 3, m+1) int32 diagonal-major cost lanes, or None.
    """

    final3: jax.Array
    moves: jax.Array | None
    planes: jax.Array | None


def default_boundary(
    tok_a_ext: jax.Array,
    tok_b_ext: jax.Array,
    cost_mat: jax.Array,
    gap_id,
    gap_open,
):
    """Standard DP boundary rows (reference ``make_dp_array``, globaligner.py:756-821).

    Returns:
        row0: (3, n+1) int32 — dp[0][j]; level Ix accumulates
            ``gap_open + sum dcost(b_1..b_j)``, levels M/Iy are BIG except
            dp[0][0] = (0, 0, 0).
        col0: (3, m+1) int32 — dp[i][0]; level Iy accumulates
            ``gap_open + sum icost(a_1..a_i)``.
    """
    n1 = tok_b_ext.shape[0]
    m1 = tok_a_ext.shape[0]
    dsteps = cost_mat[gap_id, tok_b_ext]  # (n+1,) dcost(b_j); entry 0 unused
    isteps = cost_mat[tok_a_ext, gap_id]  # (m+1,)

    ix_row = gap_open + jnp.cumsum(dsteps.at[0].set(0))
    iy_col = gap_open + jnp.cumsum(isteps.at[0].set(0))

    big_row = jnp.full((n1,), BIG, dtype=jnp.int32)
    big_col = jnp.full((m1,), BIG, dtype=jnp.int32)
    row0 = jnp.stack([big_row, ix_row.astype(jnp.int32), big_row])
    col0 = jnp.stack([big_col, big_col, iy_col.astype(jnp.int32)])
    row0 = row0.at[:, 0].set(0)  # dp[0][0] = (0, 0, 0)
    col0 = col0.at[:, 0].set(0)
    return row0, col0


def _shift_in_big(x: jax.Array) -> jax.Array:
    """out[..., i] = x[..., i-1]; out[..., 0] = BIG (row shift along lanes)."""
    pad = jnp.full(x.shape[:-1] + (1,), BIG, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def wavefront_fill_impl(
    tok_a_ext: jax.Array,
    tok_b_ext: jax.Array,
    cost_mat: jax.Array,
    gap_id: jax.Array,
    gap_open: jax.Array,
    row0: jax.Array | None = None,
    col0: jax.Array | None = None,
    m_true: jax.Array | None = None,
    n_true: jax.Array | None = None,
    *,
    want_moves: bool = True,
    want_planes: bool = False,
    unroll: int = 1,
) -> FillResult:
    """Fill the Gotoh DP matrix by anti-diagonals.

    Args:
        tok_a_ext: (m+1,) int32, 1-origin tokens of seq_1 (entry 0 is a dummy).
        tok_b_ext: (n+1,) int32, 1-origin tokens of seq_2.
        cost_mat: (A, A) int32 costing matrix (gap symbol included).
        gap_id: scalar int32 token id of the gap symbol.
        gap_open: scalar int32 gap-open transition cost.
        row0 / col0: optional explicit boundary (3, n+1) / (3, m+1) — used by
            the conformance test that pre-seeds a custom boundary
            (reference tests/globaligner_test.py:6-37); default is the
            standard boundary of :func:`default_boundary`.
        m_true / n_true: optional traced per-pair true lengths when the token
            buffers are padded past the real sequences (length-bucketed batch
            mode).  The DP result is extracted at cell (m_true, n_true) on
            diagonal ``m_true + n_true`` during the scan; padded cells are
            computed but never read (cell (i, j) only depends on cells with
            smaller i and j, so padding cannot contaminate real cells).
        want_moves: emit packed argmin codes for the traceback.
        want_planes: emit all three cost lanes per diagonal (debug/oracle use;
            O(m·n) memory).

    Sharding note: this function is vmap-compatible over a leading batch axis
    of (tok_a_ext, tok_b_ext, m_true, n_true) — the batched pair engine
    relies on that.
    """
    m1 = tok_a_ext.shape[0]  # m + 1
    n1 = tok_b_ext.shape[0]  # n + 1
    m = m1 - 1
    n = n1 - 1
    A = cost_mat.shape[0]

    if m_true is None:
        m_true = jnp.int32(m)
    if n_true is None:
        n_true = jnp.int32(n)
    m_true = jnp.asarray(m_true, jnp.int32)
    n_true = jnp.asarray(n_true, jnp.int32)

    gap_open = jnp.asarray(gap_open, jnp.int32)
    cost_flat = cost_mat.reshape(-1).astype(jnp.int32)

    if row0 is None or col0 is None:
        row0, col0 = default_boundary(
            tok_a_ext, tok_b_ext, cost_mat, gap_id, gap_open
        )
    row0 = row0.astype(jnp.int32)
    col0 = col0.astype(jnp.int32)

    i_idx = jnp.arange(m1, dtype=jnp.int32)
    isteps = cost_mat[tok_a_ext, gap_id].astype(jnp.int32)  # icost(a_i), (m+1,)

    # Diagonal 0 holds only cell (0, 0); diagonal 1 holds (0, 1) and (1, 0).
    d0 = jnp.full((3, m1), BIG, jnp.int32).at[:, 0].set(row0[:, 0])
    d1 = jnp.full((3, m1), BIG, jnp.int32)
    if n >= 1:
        d1 = d1.at[:, 0].set(row0[:, 1])
    if m >= 1:
        d1 = d1.at[:, 1].set(col0[:, 1])

    k_final = m_true + n_true  # diagonal holding cell (m_true, n_true)

    def step(carry, k):
        prev1, prev2, final3 = carry  # diagonals k-1, k-2: (3, m+1) each
        j_idx = k - i_idx  # column of lane i on this diagonal

        bj = tok_b_ext[jnp.clip(j_idx, 0, n)]  # (m+1,) tokens b_{k-i}
        sub = cost_flat[tok_a_ext * A + bj]  # sub(a_i, b_j)
        dstep = cost_flat[gap_id * A + bj]  # dcost(b_j)

        p2s = _shift_in_big(prev2)  # lane i reads (i-1, j-1)
        p1s = _shift_in_big(prev1)  # lane i reads (i-1, j)

        cand_m = p2s  # order (M, Ix, Iy): argmin tie-break prefers M, then Ix
        cand_x = jnp.stack([prev1[0] + gap_open, prev1[1], prev1[2] + gap_open])
        cand_y = jnp.stack([p1s[0] + gap_open, p1s[1] + gap_open, p1s[2]])

        v_m = jnp.min(cand_m, axis=0) + sub
        v_x = jnp.min(cand_x, axis=0) + dstep
        v_y = jnp.min(cand_y, axis=0) + isteps
        cur = jnp.stack([v_m, v_x, v_y])

        # Boundary and validity masks (replaces Python branches).
        on_row0 = (i_idx == 0)[None, :]
        on_col0 = (j_idx == 0)[None, :]
        invalid = ((j_idx < 0) | (j_idx > n))[None, :]
        cur = jnp.where(on_row0, row0[:, jnp.clip(k, 0, n)][:, None], cur)
        cur = jnp.where(on_col0, col0[:, jnp.clip(k, 0, m)][:, None], cur)
        cur = jnp.where(invalid, BIG, cur)

        final3 = jnp.where(
            k == k_final, jnp.take(cur, m_true, axis=1), final3
        )

        ys = []
        if want_moves:
            code = (
                jnp.argmin(cand_m, axis=0)
                + 4 * jnp.argmin(cand_x, axis=0)
                + 16 * jnp.argmin(cand_y, axis=0)
            ).astype(jnp.uint8)
            ys.append(code)
        if want_planes:
            ys.append(cur)
        return (cur, prev1, final3), tuple(ys)

    ks = jnp.arange(2, m + n + 1, dtype=jnp.int32)
    # Derive the accumulator from d1 (not a fresh constant) so that under
    # shard_map its varying-axes annotation matches the scan body's output.
    final3_init = jnp.full_like(d1[:, 0], BIG)
    (_, _, final3), ys = jax.lax.scan(step, (d1, d0, final3_init), ks, unroll=unroll)

    moves = None
    planes = None
    pos = 0
    if want_moves:
        body = ys[pos]
        pos += 1
        moves = jnp.concatenate(
            [jnp.zeros((2, m1), jnp.uint8), body], axis=0
        )
    if want_planes:
        body = ys[pos]
        head = jnp.stack([d0, d1])
        planes = jnp.concatenate([head, body], axis=0)

    return FillResult(final3=final3, moves=moves, planes=planes)


# Jitted single-pair entry point (shapes cached per (m, n)).
wavefront_fill = functools.partial(
    jax.jit(
        wavefront_fill_impl,
        static_argnames=("want_moves", "want_planes", "unroll"),
    )
)


@functools.partial(
    jax.jit, static_argnames=("want_moves", "want_planes", "unroll")
)
def wavefront_fill_batch(
    tok_a_ext: jax.Array,
    tok_b_ext: jax.Array,
    cost_mat: jax.Array,
    gap_id: jax.Array,
    gap_open: jax.Array,
    m_true: jax.Array,
    n_true: jax.Array,
    *,
    want_moves: bool = False,
    want_planes: bool = False,
    unroll: int = 1,
) -> FillResult:
    """vmap of the wavefront fill over a leading batch axis.

    Args:
        tok_a_ext / tok_b_ext: (B, M+1) / (B, N+1) padded 1-origin tokens.
        m_true / n_true: (B,) per-pair true lengths.

    Returns a FillResult with a leading batch axis on every populated field.
    """

    def one(ta, tb, mt, nt):
        return wavefront_fill_impl(
            ta,
            tb,
            cost_mat,
            gap_id,
            gap_open,
            None,
            None,
            mt,
            nt,
            want_moves=want_moves,
            want_planes=want_planes,
            unroll=unroll,
        )

    return jax.vmap(one)(tok_a_ext, tok_b_ext, m_true, n_true)


def planes_to_dense(planes: np.ndarray, m: int, n: int) -> np.ndarray:
    """Convert diagonal-major planes (m+n+1, 3, m+1) to dense (3, m+1, n+1).

    Host-side helper for tests/oracles; cells outside the matrix are BIG.
    """
    planes = np.asarray(planes)
    out = np.full((3, m + 1, n + 1), BIG, dtype=np.int32)
    for k in range(m + n + 1):
        lo = max(0, k - n)
        hi = min(m, k)
        i = np.arange(lo, hi + 1)
        out[:, i, k - i] = planes[k][:, i]
    return out
