"""Sequence parallelism: one pair's DP fill column-sharded across devices.

The engine's primary scaling axis is the independent-pair batch
(:mod:`.mesh`); this module adds the optional second axis from SURVEY.md §5
(long-context row): a SINGLE huge pair whose DP matrix is split into column
strips, one per device, filled as a pipelined wavefront with halo exchange
of strip edges over the interconnect (the "wavefront-with-neighbor-exchange"
pattern playing the context-parallelism role, expressed as XLA
collectives inside ``shard_map``).

Schedule: seq_2 is split into D contiguous EQUAL-WIDTH strips of
``W = ceil(n / D)`` columns (device d owns strip d; columns past ``n`` are
pad, right of every real cell, and never feed one); seq_1 is split into row
blocks of ``block_rows``.  At super-step t device d fills row block
``t - d`` of its strip — a skewed pipeline, so all D devices are busy once
the pipe fills (t >= D-1).  After each super-step every device sends the
3-lane right-edge column of the rows it just filled to its right neighbor
via ``lax.ppermute`` — O(3 * block_rows) ints per step over the
interconnect, no per-cell traffic.

Each block runs the XLA row scan with an interior left boundary and
per-row edge streaming (ops/fill_rows ``col0_full`` / ``want_edge``),
pinned strip-exact to the single-device fill by tests/test_seqpar.py.

Wall-clock: ceil(m/RB) + D - 1 super-steps of an (RB x W) block each.
Cost-only (tracebacks for huge pairs go through the checkpointed replay).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fill_rows import row_fill_impl
from ..ops.fill_scan import BIG, default_boundary

STRIP_AXIS = "strips"


def make_strip_mesh(devices=None) -> Mesh:
    """1-D mesh over devices, axis ``strips`` (one column strip each)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (STRIP_AXIS,))


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "m", "nblocks", "block_rows", "dstar", "c_read",
    ),
)
def _seqpar_cost_jit(
    mesh,
    tok_a_pad,  # (nblocks*RB + 1,) replicated, 1-origin, padded
    tok_b_strips,  # (D, W+1) one padded 1-origin strip per device
    strip_row0,  # (D, 3, W+1) global row-0 boundary per strip
    cost_mat,
    gap_id,
    gap_open,
    m: int,
    nblocks: int,
    block_rows: int,
    dstar: int,
    c_read: int,
):
    D = mesh.devices.size
    RB = block_rows
    nsteps = nblocks + D - 1
    gap_open = jnp.asarray(gap_open, jnp.int32)

    def shard_fn(tok_b_s, row0_s):
        d = jax.lax.axis_index(STRIP_AXIS)
        tok_b_local = tok_b_s[0]  # (W+1,)
        row0 = row0_s[0].astype(jnp.int32)  # (3, W+1)
        W = tok_b_local.shape[0] - 1

        # Device 0's left edge is the true matrix column-0 boundary
        # (depends only on seq_1 / gap costs — computable everywhere).
        _, col0_g = default_boundary(
            tok_a_pad, tok_b_local, cost_mat, gap_id, gap_open
        )
        col0_g = col0_g.astype(jnp.int32)

        def super_step(t, carry):
            state, edges_in, final3 = carry
            b = t - d  # row block this device fills now
            active = (b >= 0) & (b < nblocks)
            bc = jnp.clip(b, 0, nblocks - 1)
            i0 = bc * RB
            rows = jnp.minimum(RB, m - i0)  # true rows in this block

            ta_blk = jax.lax.dynamic_slice(tok_a_pad, (i0,), (RB + 1,))
            ta_blk = ta_blk.at[0].set(0)

            col0_own = jax.lax.dynamic_slice(col0_g, (0, i0), (3, RB + 1))
            col0_blk = jnp.where(d == 0, col0_own, edges_in)

            res = row_fill_impl(
                ta_blk,
                tok_b_local,
                cost_mat,
                gap_id,
                gap_open,
                state,
                col0_blk,
                rows,
                jnp.int32(c_read),
                want_moves=False,
                col0_full=True,
                want_edge=True,
                edge_col=jnp.int32(W),
            )
            last, fin3, edge = res.last3, res.final3, res.edge.T

            new_state = jnp.where(active, last, state)
            final3 = jnp.where(active & (b == nblocks - 1), fin3, final3)

            # Right-edge column over this block's rows: local row 0 = the
            # incoming state's edge value (the neighbor's diagonal read at
            # its first row), rows 1..RB from the fill's edge stream.
            edge_out = jnp.concatenate(
                [state[:, W][:, None], edge], axis=1
            )  # (3, RB+1)
            edge_out = jnp.where(
                active, edge_out, jnp.full_like(edge_out, BIG)
            )

            edges_next = jax.lax.ppermute(
                edge_out,
                STRIP_AXIS,
                [(k, (k + 1) % D) for k in range(D)],
            )
            return new_state, edges_next, final3

        carry0 = (
            row0,
            jnp.full((3, RB + 1), BIG, jnp.int32),
            jnp.full((3,), BIG, jnp.int32),
        )
        _, _, final3 = jax.lax.fori_loop(0, nsteps, super_step, carry0)
        # The overall optimum lives on the strip owning global column n.
        return jnp.where(d == dstar, final3, jnp.zeros(3, jnp.int32))[None]

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(STRIP_AXIS), P(STRIP_AXIS)),
        out_specs=P(STRIP_AXIS),
        check_vma=False,
    )
    out = fn(tok_b_strips, strip_row0)  # (D, 3)
    return out[dstar]


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "m", "nblocks", "block_rows"),
)
def _seqpar_rows_jit(
    mesh,
    tok_a_pad,  # (nblocks*RB + 1,) replicated block tokens, 1-origin
    tok_b_strips,  # (D, W+1) one padded 1-origin strip per device
    row0_full,  # (3, D*W + 1) REPLICATED row-0 boundary (checkpoint row)
    col0,  # (3, nblocks*RB + 1) column-0 triple of the block, replicated
    cost_mat,
    gap_id,
    gap_open,
    m: int,
    nblocks: int,
    block_rows: int,
):
    """Column-sharded K-row block fill returning the block's LAST row,
    reassembled and replicated as (3, D*W + 1) — the checkpoint-pass
    primitive of the blocked linear-space traceback run across devices
    (align_blocked's huge-pair axis; SURVEY.md §5 long-context row).
    Same super-step pipeline as :func:`_seqpar_cost_jit`, with the
    row-0/column-0 boundaries INJECTED (the previous checkpoint row)
    instead of the global formulas.  The output has the input
    ``row0_full``'s layout so consecutive blocks chain as device arrays
    with no host round trips (only the small tok_a/col0 host tables move
    per block)."""
    D = mesh.devices.size
    RB = block_rows
    nsteps = nblocks + D - 1
    gap_open = jnp.asarray(gap_open, jnp.int32)

    def shard_fn(tok_b_s, row0_f):
        d = jax.lax.axis_index(STRIP_AXIS)
        tok_b_local = tok_b_s[0]  # (W+1,)
        W = tok_b_local.shape[0] - 1
        # This strip's window of the replicated checkpoint row: global
        # columns d*W .. d*W + W.
        row0 = jax.lax.dynamic_slice(
            row0_f.astype(jnp.int32), (0, d * W), (3, W + 1)
        )
        col0_g = jnp.asarray(col0, jnp.int32)

        def super_step(t, carry):
            state, edges_in = carry
            b = t - d
            active = (b >= 0) & (b < nblocks)
            bc = jnp.clip(b, 0, nblocks - 1)
            i0 = bc * RB
            rows = jnp.minimum(RB, m - i0)

            ta_blk = jax.lax.dynamic_slice(tok_a_pad, (i0,), (RB + 1,))
            ta_blk = ta_blk.at[0].set(0)
            col0_own = jax.lax.dynamic_slice(col0_g, (0, i0), (3, RB + 1))
            col0_blk = jnp.where(d == 0, col0_own, edges_in)

            res = row_fill_impl(
                ta_blk,
                tok_b_local,
                cost_mat,
                gap_id,
                gap_open,
                state,
                col0_blk,
                rows,
                jnp.int32(W),
                want_moves=False,
                col0_full=True,
                want_edge=True,
                edge_col=jnp.int32(W),
                want_fin_row=True,
            )
            # fin_row (the row at ``rows``), NOT last3: the final
            # sub-block of a K-row block may be partial, and the
            # padded scan rows past ``rows`` are garbage.
            last, edge = res.fin_row, res.edge.T

            new_state = jnp.where(active, last, state)
            edge_out = jnp.concatenate(
                [state[:, W][:, None], edge], axis=1
            )
            edge_out = jnp.where(
                active, edge_out, jnp.full_like(edge_out, BIG)
            )
            edges_next = jax.lax.ppermute(
                edge_out,
                STRIP_AXIS,
                [(k, (k + 1) % D) for k in range(D)],
            )
            return new_state, edges_next

        carry0 = (row0, jnp.full((3, RB + 1), BIG, jnp.int32))
        state, _ = jax.lax.fori_loop(0, nsteps, super_step, carry0)
        # Replicate every strip's last row (multi-host safe, like the
        # mesh cost path) and reassemble the global checkpoint row in
        # the row0_full layout: column 0 is the block's last column-0
        # boundary cell, columns 1..D*W the strips' interiors.
        gathered = jax.lax.all_gather(state, STRIP_AXIS)  # (D, 3, W+1)
        body = jnp.moveaxis(gathered[:, :, 1:], 0, 1).reshape(3, D * W)
        return jnp.concatenate([col0_g[:, m][:, None], body], axis=1)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(STRIP_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(tok_b_strips, row0_full)  # (3, D*W + 1) replicated


class ShardedCheckpointFill:
    """Per-pair context for the mesh-sharded checkpoint pass.

    Built ONCE per ``align_blocked(mesh=...)`` call: the column strips of
    seq_2 are cut, device_put and the scheme constants staged a single
    time; :meth:`block_last_rows` then chains consecutive blocks through
    a REPLICATED device row — no per-block device->host fetch of the
    checkpoint row and no per-block re-upload of the strips.  Only the
    O(K) tok_a/col0 host tables move per block.
    """

    def __init__(
        self,
        mesh: Mesh,
        tok_b_ext,
        cost_mat,
        gap_id,
        gap_open,
        *,
        block_rows: int = 256,
    ):
        if mesh.axis_names != (STRIP_AXIS,):
            # Callers hand over whatever 1-D mesh they scale on (e.g. the
            # batch engine's "pairs" mesh); re-label its devices as strips.
            mesh = Mesh(mesh.devices.reshape(-1), (STRIP_AXIS,))
        self.mesh = mesh
        self.D = mesh.devices.size
        tok_b_np = np.asarray(tok_b_ext, dtype=np.int32)
        self.n = tok_b_np.shape[0] - 1
        self.W = -(-self.n // self.D)
        self.block_rows = block_rows

        tok_b_strips = np.zeros((self.D, self.W + 1), np.int32)
        for dd in range(self.D):
            c0 = dd * self.W
            if c0 > self.n:
                continue
            hi = min(self.W, self.n - c0)
            tok_b_strips[dd, 1 : hi + 1] = tok_b_np[c0 + 1 : c0 + hi + 1]
        self.tok_b_d = jax.device_put(
            jnp.asarray(tok_b_strips), NamedSharding(mesh, P(STRIP_AXIS))
        )
        self.cost_mat = jnp.asarray(cost_mat, jnp.int32)
        self.gap_id = jnp.asarray(gap_id, jnp.int32)
        self.gap_open = jnp.asarray(gap_open, jnp.int32)

    def pad_row0(self, row0) -> jax.Array:
        """Lift a (3, n+1) checkpoint row into the (3, D*W+1) replicated
        layout the sharded fill chains through (padding is BIG; padded
        columns never feed real ones)."""
        row0 = jnp.asarray(row0, jnp.int32)
        return jnp.pad(
            row0,
            ((0, 0), (0, self.D * self.W + 1 - row0.shape[1])),
            constant_values=BIG,
        )

    def block_last_rows(self, tok_a_blk, row0_full, col0) -> jax.Array:
        """Last DP row of one K-row block as the next (3, D*W+1)
        replicated device row.

        Args:
            tok_a_blk: (K+1,) 1-origin block tokens (host).
            row0_full: (3, D*W+1) the previous block's return (or
                :meth:`pad_row0` of the global row-0 boundary).
            col0: (3, K+1) the block's column-0 triple (host).
        """
        tok_a_np = np.asarray(tok_a_blk, dtype=np.int32)
        K = tok_a_np.shape[0] - 1
        RB = max(1, min(self.block_rows, K))
        nblocks = max(1, -(-K // RB))
        tok_a_pad = np.zeros((nblocks * RB + 1,), np.int32)
        tok_a_pad[: K + 1] = tok_a_np
        col0_np = np.asarray(col0, dtype=np.int32)
        col0_pad = np.pad(
            col0_np, ((0, 0), (0, nblocks * RB + 1 - col0_np.shape[1])),
            mode="edge",
        )
        return _seqpar_rows_jit(
            self.mesh,
            jnp.asarray(tok_a_pad),
            self.tok_b_d,
            jnp.asarray(row0_full, jnp.int32),
            jnp.asarray(col0_pad),
            self.cost_mat,
            self.gap_id,
            self.gap_open,
            K,
            nblocks,
            RB,
        )


def sharded_block_last_rows(
    mesh: Mesh,
    tok_a_blk,
    tok_b_ext,
    cost_mat,
    gap_id,
    gap_open,
    row0,
    col0,
    *,
    block_rows: int = 256,
) -> np.ndarray:
    """Last DP row (3, n+1) of a K-row block, column-sharded over ``mesh``.

    One-shot convenience over :class:`ShardedCheckpointFill` (which
    align_blocked uses directly to chain blocks on device): each device
    owns an equal-width column strip of the block, blocks pipeline in
    ``block_rows`` sub-blocks with ppermute edge exchange, and the
    resulting row is bit-identical to the single-device block fill
    (pinned by tests/test_seqpar.py).

    Args:
        tok_a_blk: (K+1,) 1-origin block tokens.
        tok_b_ext: (n+1,) 1-origin seq_2 tokens (padded width ok).
        row0: (3, n+1) the triple row above the block (checkpoint row).
        col0: (3, K+1) the block's column-0 triple
            ((BIG, BIG, Iy) rows of the global boundary).
    """
    ctx = ShardedCheckpointFill(
        mesh, tok_b_ext, cost_mat, gap_id, gap_open, block_rows=block_rows
    )
    out_full = ctx.block_last_rows(tok_a_blk, ctx.pad_row0(row0), col0)
    return np.asarray(out_full[:, : ctx.n + 1])


def sharded_pair_cost(
    mesh: Mesh,
    tok_a_ext,
    tok_b_ext,
    cost_mat,
    gap_id,
    gap_open,
    *,
    block_rows: int = 256,
) -> np.ndarray:
    """Optimal-cost lanes (3,) of ONE pair, column-sharded over ``mesh``.

    Args:
        tok_a_ext / tok_b_ext: (m+1,) / (n+1,) int32 1-origin tokens.
        block_rows: rows per pipeline super-step (pipeline fill latency is
            (D-1) * block_rows rows; halo traffic is 3*(block_rows+1) ints
            per device per step).

    ``min`` of the result is the optimal alignment cost, identical to the
    single-device fill.
    """
    tok_a_np = np.asarray(tok_a_ext, dtype=np.int32)
    tok_b_np = np.asarray(tok_b_ext, dtype=np.int32)
    m = tok_a_np.shape[0] - 1
    n = tok_b_np.shape[0] - 1
    D = mesh.devices.size
    if n < D:
        # Degenerate geometry: fewer columns than devices — a pair this
        # small has nothing to parallelize; fill it on one device.
        from ..ops.fill_rows import row_fill

        res = row_fill(
            jnp.asarray(tok_a_np),
            jnp.asarray(tok_b_np),
            jnp.asarray(cost_mat, jnp.int32),
            jnp.asarray(gap_id, jnp.int32),
            jnp.asarray(gap_open, jnp.int32),
            want_moves=False,
        )
        return np.asarray(res.final3)
    RB = max(1, block_rows)
    nblocks = max(1, -(-m // RB))

    tok_a_pad = np.zeros((nblocks * RB + 1,), np.int32)
    tok_a_pad[: m + 1] = tok_a_np

    # Equal-width contiguous strips: strip d owns global columns
    # (d*W, (d+1)*W], its local dummy position 0 standing for global
    # column d*W (the shared edge).  Columns past n are pad — they sit to
    # the right of every real cell and never feed one; the strip edge is
    # therefore a STATIC column, streamed per row by the fill.
    W = -(-n // D)
    dstar = (n - 1) // W  # strip owning global column n
    c_read = n - dstar * W
    tok_b_strips = np.zeros((D, W + 1), np.int32)
    strip_row0 = np.full((D, 3, W + 1), BIG, np.int32)

    row0_g, _ = default_boundary(
        jnp.asarray(tok_a_np),
        jnp.asarray(tok_b_np),
        jnp.asarray(cost_mat, jnp.int32),
        gap_id,
        jnp.asarray(gap_open, jnp.int32),
    )
    row0_g = np.asarray(row0_g)

    for dd in range(D):
        c0 = dd * W
        if c0 > n:
            continue  # strip is pure pad; its BIG boundary is never read
        hi = min(W, n - c0)  # real columns in this strip
        tok_b_strips[dd, 1 : hi + 1] = tok_b_np[c0 + 1 : c0 + hi + 1]
        strip_row0[dd, :, : hi + 1] = row0_g[:, c0 : c0 + hi + 1]

    sharding = NamedSharding(mesh, P(STRIP_AXIS))
    tok_b_d = jax.device_put(jnp.asarray(tok_b_strips), sharding)
    row0_d = jax.device_put(jnp.asarray(strip_row0), sharding)

    final3 = _seqpar_cost_jit(
        mesh,
        jnp.asarray(tok_a_pad),
        tok_b_d,
        row0_d,
        jnp.asarray(cost_mat, jnp.int32),
        jnp.asarray(gap_id, jnp.int32),
        jnp.asarray(gap_open, jnp.int32),
        m,
        nblocks,
        RB,
        dstar,
        c_read,
    )
    return np.asarray(final3)
