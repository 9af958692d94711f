"""Data-parallel sharding of the pair batch over a device mesh.

The reference is single-process with no parallelism of any kind (SURVEY.md
§2: no DP/TP/PP, no collectives).  The engine's primary scaling axis is
the *independent-pair batch*: a 1-D ``jax.sharding.Mesh`` over all
devices, the batch axis sharded with ``shard_map``, per-pair score
vectors merged with ``lax.all_gather`` (and global cell counts with
``psum``) so every host holds the full result.  No per-cell
cross-device traffic is required — each pair's DP matrix lives entirely
on one device (SURVEY.md §3.3).

Multi-host entry: :func:`globalign_jax.parallel.multihost.initialize`
before building the mesh; everything below is host-count agnostic (inputs
go through ``jax.make_array_from_callback``, outputs come back replicated).
Exercised by the 2-process CPU harness in tests/test_multihost.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fill_rows

BATCH_AXIS = "pairs"


def _put(a, sharding) -> jax.Array:
    """Host array -> device array under ``sharding``; works identically in
    single- and multi-host runs (each process materializes only the shards
    of its addressable devices from the host-replicated full batch)."""
    a = np.asarray(a)
    return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])


def make_pair_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, batch axis ``pairs``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def pad_batch_to_mesh(arrays, batch: int, mesh: Mesh) -> tuple[list, int]:
    """Pad every array's leading axis to a multiple of the mesh size.

    Padding replicates row 0 (a valid pair — results for pad rows are simply
    dropped by the caller).  Returns (padded_arrays, padded_batch).
    """
    size = mesh.devices.size
    padded = -(-batch // size) * size
    if padded == batch:
        return list(arrays), batch
    out = []
    for a in arrays:
        pad = np.broadcast_to(a[:1], (padded - batch,) + a.shape[1:])
        out.append(np.concatenate([a, pad], axis=0))
    return out, padded


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_costs_jit(
    mesh, tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true
):
    spec_b = P(BATCH_AXIS)

    def shard_fn(ta, tb, cm, gi, go, mt, nt):
        final3 = fill_rows.row_fill_batch(
            ta, tb, cm, gi, go, mt, nt, want_moves=False
        ).final3
        # Collective merge (SURVEY.md §2 new-component row 5): every shard
        # gathers the full per-pair score vector, so the result is
        # replicated and every HOST can read all pairs without fetching
        # another host's shards — this is what makes the multi-host path
        # work (a process may only read addressable shards).  Traffic is
        # B x 3 ints — negligible next to the fills.
        gathered = jax.lax.all_gather(final3, BATCH_AXIS, axis=0, tiled=True)
        local_cells = jnp.sum(mt.astype(jnp.float32) * nt.astype(jnp.float32))
        total_cells = jax.lax.psum(local_cells, BATCH_AXIS)
        return gathered, total_cells

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_b, spec_b, P(), P(), P(), spec_b, spec_b),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_moves_jit(
    mesh, tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true
):
    spec_b = P(BATCH_AXIS)

    def shard_fn(ta, tb, cm, gi, go, mt, nt):
        res = fill_rows.row_fill_batch(
            ta, tb, cm, gi, go, mt, nt, want_moves=True
        )
        # Final lanes are tiny — gather them so every host reads all pairs;
        # move matrices are O(m*n) per pair and stay SHARDED across the
        # mesh's devices (the host fetch below reads them shard-wise).
        gathered = jax.lax.all_gather(
            res.final3, BATCH_AXIS, axis=0, tiled=True
        )
        return gathered, res.moves

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_b, spec_b, P(), P(), P(), spec_b, spec_b),
        out_specs=(P(), spec_b),
        check_vma=False,
    )
    return fn(tok_a, tok_b, cost_mat, gap_id, gap_open, m_true, n_true)


def sharded_fill_moves(
    mesh: Mesh,
    tok_a: np.ndarray,
    tok_b: np.ndarray,
    cost_mat,
    gap_id,
    gap_open,
    m_true: np.ndarray,
    n_true: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Traceback-capable batched fill, batch axis sharded across ``mesh``.

    Returns ``(final3 (B, 3), moves (B, M+1, N+1))`` host numpy, pad rows
    dropped, moves in the row layout of
    :func:`globalign_jax.ops.fill_rows.row_fill_batch`.

    Requires a PROCESS-LOCAL mesh: the O(m*n) move matrices stay sharded
    on device and the host fetch can only read addressable shards.
    Multi-host runs shard *chunks* over processes (runner + multihost)
    and give each process a mesh over its local devices — exactly what
    ``batch_cli --distributed --shard`` does.
    """
    if any(
        d.process_index != jax.process_index()
        for d in mesh.devices.flat
    ):
        raise ValueError(
            "sharded_fill_moves needs a process-local mesh (the sharded "
            "move matrices are fetched to THIS host); multi-host runs "
            "split chunks over processes and use a local mesh per host "
            "(see globalign_jax.parallel.multihost)."
        )
    batch = tok_a.shape[0]
    (tok_a, tok_b, m_true, n_true), _ = pad_batch_to_mesh(
        (tok_a, tok_b, m_true, n_true), batch, mesh
    )
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    final3, moves = _sharded_moves_jit(
        mesh,
        _put(tok_a, sharding),
        _put(tok_b, sharding),
        jnp.asarray(cost_mat),
        jnp.asarray(gap_id),
        jnp.asarray(gap_open),
        _put(np.asarray(m_true, np.int32), sharding),
        _put(np.asarray(n_true, np.int32), sharding),
    )
    return np.asarray(final3)[:batch], np.asarray(moves)[:batch]


def sharded_fill_costs(
    mesh: Mesh,
    tok_a: np.ndarray,
    tok_b: np.ndarray,
    cost_mat,
    gap_id,
    gap_open,
    m_true: np.ndarray,
    n_true: np.ndarray,
) -> np.ndarray:
    """Cost-only batched fill, batch axis sharded across ``mesh``.

    Returns (B, 3) final DP values per pair (host numpy, pad rows dropped).
    """
    batch = tok_a.shape[0]
    (tok_a, tok_b, m_true, n_true), _ = pad_batch_to_mesh(
        (tok_a, tok_b, m_true, n_true), batch, mesh
    )
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    final3, _total_cells = _sharded_costs_jit(
        mesh,
        _put(tok_a, sharding),
        _put(tok_b, sharding),
        jnp.asarray(cost_mat),
        jnp.asarray(gap_id),
        jnp.asarray(gap_open),
        _put(np.asarray(m_true, np.int32), sharding),
        _put(np.asarray(n_true, np.int32), sharding),
    )
    return np.asarray(final3)[:batch]
