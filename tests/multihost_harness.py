"""Worker process for the 2-process multi-host test (run via subprocess).

Each OS process gets 4 virtual CPU devices; ``jax.distributed.initialize``
joins them into one 8-device runtime with real (Gloo) collectives between
the processes — the same code path a multi-host GPU cluster runs over its
interconnect.

Usage: python multihost_harness.py <process_id> <port> <outdir>
"""

import json
import os
import sys


def _pairs():
    """Deterministic 16 DNA pairs (identical in every process)."""
    import numpy as np

    rng = np.random.default_rng(1234)
    pairs = []
    for _ in range(16):
        m = int(rng.integers(3, 40))
        n = int(rng.integers(3, 40))
        pairs.append(
            (
                "".join(rng.choice(list("ACGT"), m)),
                "".join(rng.choice(list("ACGT"), n)),
            )
        )
    return pairs


def main() -> int:
    pid, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from globalign_jax.parallel.multihost import initialize

    ppid, pcount = initialize(f"localhost:{port}", 2, pid)
    assert (ppid, pcount) == (pid, 2), (ppid, pcount)
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4

    from globalign_jax.parallel.mesh import make_pair_mesh, sharded_fill_costs
    from globalign_jax.runner import BatchRunner

    # Phase 1 — host-sharded throughput mode: each process aligns its
    # round-robin share of the chunks on a mesh of its LOCAL devices.
    # Independent chunks must NOT run collectives over a global mesh from
    # one process at a time (multi-controller JAX requires every process
    # to issue the same global program), so cross-host scaling of the pair
    # stream is chunk-level data parallelism with zero DCN traffic.
    runner = BatchRunner(
        output=os.path.join(outdir, "out.tsv"),
        chunk_pairs=4,
        mesh=make_pair_mesh(jax.local_devices()),
        process_id=pid,
        num_processes=2,
        log=open(os.devnull, "w"),
    )
    stats = runner.run(_pairs())

    # Phase 2 — lockstep collective mode: BOTH processes enter the same
    # global-mesh program on the same batch; the batch axis spans the two
    # processes and lax.all_gather merges results over the (here: Gloo,
    # on a pod: ICI/DCN) interconnect.
    import numpy as np

    from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
    from globalign_jax.utils.matrices import create_scoring_mat
    from globalign_jax.utils.tokenize import Alphabet, encode_padded

    alpha = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alpha, 2, -3, -2), max_score=2
    )
    pairs = _pairs()
    M = max(len(s1) for s1, _ in pairs)
    N = max(len(s2) for _, s2 in pairs)
    tok_a = np.stack([encode_padded(alpha, s1, M) for s1, _ in pairs])
    tok_b = np.stack([encode_padded(alpha, s2, N) for _, s2 in pairs])
    m_true = np.array([len(s1) for s1, _ in pairs], np.int32)
    n_true = np.array([len(s2) for _, s2 in pairs], np.int32)
    final3 = sharded_fill_costs(
        make_pair_mesh(),  # global mesh: all 8 devices of both processes
        tok_a,
        tok_b,
        costing.values,
        alpha.gap_id,
        4,
        m_true,
        n_true,
    )
    global_costs = final3.min(axis=-1).tolist()

    # Phase 3 — huge-pair axis in lockstep: ONE pair's blocked
    # linear-space traceback with its checkpoint pass column-sharded over
    # the global mesh (seqpar.ShardedCheckpointFill; each process owns 4
    # of the 8 column strips, ppermute edges cross the process boundary)
    # — the full alignment, not just the cost, must equal the
    # single-device path.
    import jax.numpy as jnp

    from globalign_jax.ops.linear_tb import align_blocked

    rng = np.random.default_rng(77)
    s1 = "".join(rng.choice(list("ACGT"), 83))
    s2 = "".join(rng.choice(list("ACGT"), 61))
    ta1 = np.asarray(encode_padded(alpha, s1, len(s1)))
    tb1 = np.asarray(encode_padded(alpha, s2, len(s2)))
    kw = dict(block_rows=16)
    tb_local = align_blocked(
        ta1, jnp.asarray(tb1), costing.values, alpha.gap_id, 4, s1, s2, **kw
    )
    tb_global = align_blocked(
        ta1, jnp.asarray(tb1), costing.values, alpha.gap_id, 4, s1, s2,
        mesh=make_pair_mesh(), **kw
    )
    assert (tb_global.cost, tb_global.seq_1_aligned, tb_global.middle_part,
            tb_global.seq_2_aligned) == (
        tb_local.cost, tb_local.seq_1_aligned, tb_local.middle_part,
        tb_local.seq_2_aligned
    ), (tb_global.cost, tb_local.cost)

    print(
        json.dumps(
            {
                "pid": pid,
                "chunks": stats.chunks,
                "pairs": stats.pairs,
                "output": str(runner.output),
                "global_costs": global_costs,
                "blocked_pair_cost": tb_local.cost,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
