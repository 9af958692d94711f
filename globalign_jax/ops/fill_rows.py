"""Row-parallel Gotoh DP fill via a min-plus prefix scan (pure JAX).

This is the engine's fill on every platform: the vectorized formulation of
the reference's interpreted hot loop (src/globalign/globaligner.py:317-392),
replacing the anti-diagonal scan of :mod:`globalign_jax.ops.fill_scan` on
the performance path.  The diagonal scan is semantically clean but
gather-bound: every one of its m+n steps re-gathers tokens and substitution
costs at computed indices, and each step touches only one diagonal's worth
of cells.  The row formulation removes both problems.

Key identity
------------
Within row ``i`` of the Gotoh cost-space recurrence

    M [i,j] = min(M, Ix, Iy)[i-1,j-1]           + sub(a_i, b_j)
    Iy[i,j] = min(M+go, Ix+go, Iy)[i-1,j]       + icost(a_i)
    Ix[i,j] = min(M+go, Ix, Iy+go)[i,j-1]       + dcost(b_j)

the M and Iy lanes depend only on row ``i-1`` and vectorize over all ``j`` at
once.  The Ix lane's horizontal dependency is a min-plus linear recurrence

    Ix[i,j] = min(Ix[i,j-1], H[j-1]) + d_j,   H[j] = min(M[i,j], Iy[i,j]) + go

whose closed form is a prefix minimum: with ``D[j] = d_1 + ... + d_j``,

    Ix[i,j] = D[j] + min_{j' < j} (H[j'] - D[j'])

computed exactly in int32 by one ``jax.lax.cummin`` over the shifted
``H - D`` vector (costs are integers, so the subtract-cumsum trick is exact,
not a floating-point approximation).  Each of the ``m`` scan steps is then a
handful of full-width vector ops with **zero gathers** in the loop body: the
per-row substitution costs come from a precomputed ``(A, n+1)`` table
``subrows[c, j] = cost(c, b_j)`` sliced at the row character ``a_i``.

Move codes (argmin provenance for the traceback) are recovered from exact
integer equalities against each candidate, with the same deterministic tie
priority M > Ix > Iy as the diagonal fill (and as ``jnp.argmin``'s
first-minimum rule), so both fills produce identical alignments.  Moves are
emitted row-major: ``moves[i, j]`` is the packed code of cell (i, j).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .fill_scan import BIG, default_boundary


class RowFillResult(NamedTuple):
    """Result of a row-scan fill.

    Attributes:
        final3: (3,) int32 — (M, Ix, Iy) at cell (m_true, n_true); its min is
            the optimal alignment cost (reference globaligner.py:425).
        moves: (m+1, n+1) uint8 row-major packed argmin codes, or None.
            Bits 0-1 = level-M predecessor, 2-3 = level-Ix, 4-5 = level-Iy
            (0=M, 1=Ix, 2=Iy).  Row 0 is all zeros (boundary).
        planes: (3, m+1, n+1) int32 dense cost planes, or None (debug).
        last3: (3, n+1) int32 — the DP lanes of the last computed row ``m``
            (the scan's final carry, free to emit; feeds the checkpointed
            linear-space traceback).
        edge: (m, 3) int32 — per-row lanes at ``edge_col`` (want_edge mode),
            or None.
        fin_row: (3, n+1) int32 — the full DP row at ``m_true``
            (want_fin_row mode), or None.  Differs from ``last3`` when the
            buffer is row-padded past the true length (partial pipeline
            sub-blocks in parallel/seqpar.py).
    """

    final3: jax.Array
    moves: jax.Array | None
    planes: jax.Array | None
    last3: jax.Array | None = None
    edge: jax.Array | None = None
    fin_row: jax.Array | None = None


def _shift_right_big(x: jax.Array) -> jax.Array:
    """out[..., j] = x[..., j-1]; out[..., 0] = BIG."""
    pad = jnp.full(x.shape[:-1] + (1,), BIG, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def row_fill_impl(
    tok_a_ext: jax.Array,
    tok_b_ext: jax.Array,
    cost_mat: jax.Array,
    gap_id,
    gap_open,
    row0: jax.Array | None = None,
    col0: jax.Array | None = None,
    m_true: jax.Array | None = None,
    n_true: jax.Array | None = None,
    *,
    want_moves: bool = True,
    want_planes: bool = False,
    unroll: int = 1,
    col0_full: bool = False,
    want_edge: bool = False,
    want_fin_row: bool = False,
    edge_col=None,
) -> RowFillResult:
    """Fill the Gotoh DP matrix row by row (see module docstring).

    Args match :func:`globalign_jax.ops.fill_scan.wavefront_fill_impl`:
        tok_a_ext / tok_b_ext: (m+1,) / (n+1,) int32 1-origin tokens.
        cost_mat: (A, A) int32 costing matrix (gap symbol included).
        gap_id / gap_open: scalar int32.
        row0 / col0: optional explicit (3, n+1) / (3, m+1) boundary.
        m_true / n_true: optional traced true lengths for padded buffers; the
            result is read at cell (m_true, n_true).  Padded cells are
            computed but never feed real cells (dependencies only flow from
            smaller i, j).
        col0_full: treat ``col0`` as a full 3-lane interior boundary (a
            column-strip's left edge received from a neighbor device, not
            the matrix edge): cell (i, 0) takes all three lanes from
            ``col0[:, i]``, and the Ix lane's incoming horizontal chain
            (the neighbor's ``Ix`` continuing without a fresh gap-open) is
            injected as a floor on the prefix minimum.
        want_edge / edge_col: also emit, per row, the three lanes at column
            ``edge_col`` — a strip's right edge, streamed to the neighbor
            device by the sequence-parallel wavefront (O(m) extra output,
            no planes materialization).

    vmap-compatible over a leading batch axis of (tok_a_ext, tok_b_ext,
    m_true, n_true).
    """
    m = tok_a_ext.shape[0] - 1
    n = tok_b_ext.shape[0] - 1

    if m_true is None:
        m_true = jnp.int32(m)
    if n_true is None:
        n_true = jnp.int32(n)
    m_true = jnp.asarray(m_true, jnp.int32)
    n_true = jnp.asarray(n_true, jnp.int32)

    gap_open = jnp.asarray(gap_open, jnp.int32)
    cost_mat = jnp.asarray(cost_mat, jnp.int32)

    if row0 is None or col0 is None:
        row0, col0 = default_boundary(
            tok_a_ext, tok_b_ext, cost_mat, gap_id, gap_open
        )
    row0 = row0.astype(jnp.int32)
    col0 = col0.astype(jnp.int32)

    # One-time setup gathers (outside the scan): per-character substitution
    # rows over seq_2, horizontal gap steps + their prefix sum, vertical gap
    # steps per row of seq_1.
    subrows = cost_mat[:, tok_b_ext]  # (A, n+1): subrows[c, j] = cost(c, b_j)
    dsteps = cost_mat[gap_id, tok_b_ext].at[0].set(0)  # (n+1,) dcost(b_j)
    dprefix = jnp.cumsum(dsteps, dtype=jnp.int32)  # D[j]
    isteps = cost_mat[tok_a_ext, gap_id]  # (m+1,) icost(a_i)

    def step(carry, xs):
        if want_fin_row:
            mp, xp, yp, final3, fin_row = carry  # row i-1: (n+1,) each
        else:
            mp, xp, yp, final3 = carry
        i, ai, ic, m_bound, x_bound, y_bound = xs

        sub_row = jnp.take(subrows, ai, axis=0)  # (n+1,) cost(a_i, b_j)

        # Diagonal + vertical lanes: fully vectorized over j.
        mp_s = _shift_right_big(mp)
        xp_s = _shift_right_big(xp)
        yp_s = _shift_right_big(yp)
        best_prev_s = jnp.minimum(jnp.minimum(mp_s, xp_s), yp_s)
        mc = jnp.minimum(best_prev_s + sub_row, BIG)
        vy = jnp.minimum(jnp.minimum(mp + gap_open, xp + gap_open), yp)
        yc = jnp.minimum(vy + ic, BIG)

        # Column-0 boundary before H so that Ix[i,1] sees the boundary cell
        # (reference make_dp_array seeds column 0 explicitly and the fill
        # never recomputes it, globaligner.py:778-819).  In col0_full mode
        # the boundary is a neighbor strip's interior edge (all lanes real).
        mc = mc.at[0].set(m_bound)
        yc = yc.at[0].set(y_bound)

        # Horizontal lane via exclusive prefix-min of H - D (exact in int32).
        # The boundary Ix continues the neighbor's horizontal run with no
        # fresh gap-open: a floor of x_bound on the prefix (BIG when the
        # boundary is the true matrix edge, where Ix is unreachable).
        h = jnp.minimum(mc, yc) + gap_open
        p = h - dprefix
        ep = jnp.minimum(jax.lax.cummin(_shift_right_big(p)), x_bound)
        xc = jnp.minimum(dprefix + ep, BIG)
        xc = xc.at[0].set(x_bound)

        final3 = jnp.where(
            i == m_true,
            jnp.stack([mc[n_true], xc[n_true], yc[n_true]]),
            final3,
        )
        if want_fin_row:
            fin_row = jnp.where(
                i == m_true, jnp.stack([mc, xc, yc]), fin_row
            )

        ys = []
        if want_edge:
            ys.append(jnp.stack([mc[edge_idx], xc[edge_idx], yc[edge_idx]]))
        if want_moves:
            # Argmin provenance by exact equality, tie priority M > Ix > Iy
            # (first-minimum, same as jnp.argmin in fill_scan).
            code_m = jnp.where(
                mp_s == best_prev_s,
                0,
                jnp.where(xp_s == best_prev_s, 1, 2),
            )
            code_y = jnp.where(
                mp + gap_open == vy,
                0,
                jnp.where(xp + gap_open == vy, 1, 2),
            )
            # Reference candidate order for Ix is (M+go, Ix, Iy+go)
            # (globaligner.py:342-347): M wins ties, then Ix, then Iy.
            mc_s = _shift_right_big(mc)
            xc_s = _shift_right_big(xc)
            code_x = jnp.where(
                xc == mc_s + gap_open + dsteps,
                0,
                jnp.where(xc == xc_s + dsteps, 1, 2),
            )
            code = (code_m + 4 * code_x + 16 * code_y).astype(jnp.uint8)
            ys.append(code)
        if want_planes:
            ys.append(jnp.stack([mc, xc, yc]))
        if want_fin_row:
            return (mc, xc, yc, final3, fin_row), tuple(ys)
        return (mc, xc, yc, final3), tuple(ys)

    edge_idx = (
        jnp.asarray(edge_col, jnp.int32) if edge_col is not None else n_true
    )
    i_ids = jnp.arange(1, m + 1, dtype=jnp.int32)
    if col0_full:
        m_bounds, x_bounds = col0[0, 1:], col0[1, 1:]
    else:
        m_bounds = jnp.full((m,), BIG, jnp.int32)
        x_bounds = jnp.full((m,), BIG, jnp.int32)
    xs = (i_ids, tok_a_ext[1:], isteps[1:], m_bounds, x_bounds, col0[2, 1:])
    final3_init = jnp.where(
        m_true == 0,
        jnp.stack([row0[0, n_true], row0[1, n_true], row0[2, n_true]]),
        jnp.full((3,), BIG, jnp.int32),
    )
    fin_row = None
    if want_fin_row:
        fin_row_init = jnp.where(m_true == 0, row0, jnp.full_like(row0, BIG))
        carry0 = (row0[0], row0[1], row0[2], final3_init, fin_row_init)
        (lm, lx, ly, final3, fin_row), ys = jax.lax.scan(
            step, carry0, xs, unroll=unroll
        )
    else:
        carry0 = (row0[0], row0[1], row0[2], final3_init)
        (lm, lx, ly, final3), ys = jax.lax.scan(
            step, carry0, xs, unroll=unroll
        )
    last3 = jnp.stack([lm, lx, ly])

    moves = None
    planes = None
    edge = None
    pos = 0
    if want_edge:
        edge = ys[pos]  # (m, 3)
        pos += 1
    if want_moves:
        body = ys[pos]  # (m, n+1)
        pos += 1
        moves = jnp.concatenate(
            [jnp.zeros((1, n + 1), jnp.uint8), body], axis=0
        )
    if want_planes:
        body = ys[pos]  # (m, 3, n+1)
        head = row0[None]  # (1, 3, n+1)
        planes = jnp.moveaxis(jnp.concatenate([head, body], axis=0), 1, 0)

    return RowFillResult(
        final3=final3, moves=moves, planes=planes, last3=last3, edge=edge,
        fin_row=fin_row,
    )


row_fill = jax.jit(
    row_fill_impl,
    static_argnames=(
        "want_moves", "want_planes", "unroll", "col0_full", "want_edge",
        "want_fin_row",
    ),
)


@functools.partial(
    jax.jit, static_argnames=("want_moves", "want_planes", "unroll")
)
def row_fill_batch(
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
) -> RowFillResult:
    """vmap of the row fill over a leading batch axis.

    Args:
        tok_a_ext / tok_b_ext: (B, M+1) / (B, N+1) padded 1-origin tokens.
        m_true / n_true: (B,) per-pair true lengths.
    """

    def one(ta, tb, mt, nt):
        return row_fill_impl(
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
