"""Scaling-efficiency benchmark: batch throughput vs device count.

Shards a fixed-size per-device workload (weak scaling) of pair alignments
over 1, 2, ..., all visible devices with the production shard_map path and
reports pairs/s and scaling efficiency vs the single-device rate.  On
several GPUs this exercises the interconnect's collectives; during
development it runs on a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py --pairs_per_device 64 --len 256

Prints one JSON line per device count plus a summary line with the
efficiency at full width (vs_baseline is relative to an 85% target).
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _spawn_processes(args) -> int:
    """Re-exec this benchmark as N distributed processes (CPU backend,
    4 virtual devices each) and relay process 0's report lines.

    Measures the multi-process scaling axis: per-host rate (independent
    local meshes) vs the lockstep global-mesh rate across all processes
    (Gloo between CPU processes).  The workers are pinned to the CPU
    backend, so they never contend for a GPU.
    """
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.processes):
        env = dict(os.environ)
        env.update(
            GLOBALIGN_MH_PID=str(pid),
            GLOBALIGN_MH_N=str(args.processes),
            GLOBALIGN_MH_PORT=str(port),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count="
            f"{args.devices_per_process}",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable] + sys.argv,
                env=env,
                stdout=subprocess.PIPE,
                text=True,
            )
        )
    rc = 0
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        rc |= p.returncode
        if pid == 0:
            sys.stdout.write(out)
    return rc


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs_per_device", type=int, default=64)
    parser.add_argument("--len", dest="length", type=int, default=256)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument(
        "--processes",
        type=int,
        default=1,
        help="Also measure N-process distributed scaling (spawns workers).",
    )
    parser.add_argument(
        "--devices_per_process",
        type=int,
        default=4,
        help="Virtual CPU devices per spawned process.  Keep "
        "processes*devices_per_process <= physical cores: virtual "
        "devices are threads, and oversubscription reads as (fake) "
        "scaling loss (measured: 8 virtual devices on 4 cores cap "
        "single-process weak-scaling efficiency at ~0.35).",
    )
    args = parser.parse_args()

    if args.processes > 1 and "GLOBALIGN_MH_PID" not in os.environ:
        return _spawn_processes(args)

    import jax
    import numpy as np

    from globalign_jax.parallel.mesh import make_pair_mesh, sharded_fill_costs
    from globalign_jax.ops.transforms import scoring_mat_to_costing_mat
    from globalign_jax.utils.matrices import create_scoring_mat
    from globalign_jax.utils.platform import enable_compilation_cache
    from globalign_jax.utils.tokenize import Alphabet

    enable_compilation_cache()
    alphabet = Alphabet.from_letters(("A", "C", "G", "T", "-"))
    costing = scoring_mat_to_costing_mat(
        create_scoring_mat(alphabet, 2, -3, -2), max_score=2
    )

    L = args.length
    rng = np.random.default_rng(0)

    def batch(B):
        tok_a = np.zeros((B, L + 1), np.int32)
        tok_b = np.zeros((B, L + 1), np.int32)
        tok_a[:, 1:] = rng.integers(0, 4, (B, L))
        tok_b[:, 1:] = rng.integers(0, 4, (B, L))
        return tok_a, tok_b, np.full(B, L, np.int32), np.full(B, L, np.int32)

    def rate(mesh, B):
        tok_a, tok_b, m_true, n_true = batch(B)

        def run():
            return sharded_fill_costs(
                mesh, tok_a, tok_b, costing.values,
                alphabet.gap_id, 4, m_true, n_true,
            )

        run()  # compile
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = run()
            best = min(best, time.perf_counter() - t0)
        assert out.shape == (B, 3)
        return B / best

    mh_pid = os.environ.get("GLOBALIGN_MH_PID")
    if mh_pid is not None:
        # Distributed worker: per-process local-mesh rate, then the
        # lockstep global-mesh rate (every process runs the same program;
        # the batch axis spans all of them, all_gather merges results).
        from globalign_jax.parallel.multihost import initialize

        pid, P = initialize(
            f"localhost:{os.environ['GLOBALIGN_MH_PORT']}",
            int(os.environ["GLOBALIGN_MH_N"]),
            int(mh_pid),
        )
        local = jax.local_devices()
        r_local = rate(make_pair_mesh(local), args.pairs_per_device * len(local))
        r_global = rate(
            make_pair_mesh(),
            args.pairs_per_device * len(jax.devices()),
        )
        eff = r_global / (r_local * P)
        print(
            json.dumps(
                {
                    "processes": P,
                    "devices": len(jax.devices()),
                    "pairs_per_s_1proc": round(r_local, 1),
                    "pairs_per_s_global": round(r_global, 1),
                }
            )
        )
        print(
            json.dumps(
                {
                    "metric": f"scaling_efficiency_{P}proc_weak",
                    "value": round(eff, 4),
                    "unit": "fraction",
                    "vs_baseline": round(eff / 0.85, 2),
                }
            )
        )
        return 0

    devices = jax.devices()

    counts = []
    d = 1
    while d < len(devices):
        counts.append(d)
        d *= 2
    counts.append(len(devices))

    rates = {}
    for nd in counts:
        B = args.pairs_per_device * nd
        rates[nd] = rate(make_pair_mesh(devices[:nd]), B)
        print(
            json.dumps(
                {
                    "devices": nd,
                    "pairs": B,
                    "pairs_per_s": round(rates[nd], 1),
                    "gcups": round(rates[nd] * L * L / 1e9, 3),
                }
            )
        )

    full = counts[-1]
    eff = rates[full] / (rates[1] * full) if full > 1 else 1.0
    print(
        json.dumps(
            {
                "metric": f"scaling_efficiency_{full}dev_weak",
                "value": round(eff, 4),
                "unit": "fraction",
                "vs_baseline": round(eff / 0.85, 2),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
