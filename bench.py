"""Fill benchmark on one GPU: cells/s of the XLA row-scan fill.

Times cost-only fills with the host clock around ``block_until_ready``,
after a first call that compiles (reported separately as set-up time):

  * ``single``: one m x n DNA pair (default 10 kb x 10 kb), the latency
    case — its rows run one after another;
  * ``batch``: B pairs of L x L (default 64 x 1 kb) in one vmapped fill.

``--backend scan`` times the anti-diagonal oracle fill instead.  Prints
the card (nvidia-smi name and power limit), then ONE JSON line.  Exits
non-zero, printing no result, when JAX finds no GPU: a CPU number is
never reported under a device metric.

Usage: python bench.py [--m 10000 --n 10000] [--batch_pairs 64]
                       [--batch_len 1024] [--repeats 5] [--backend rows]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def _time_calls(fn, args, repeats):
    """(first-call seconds, median steady seconds per call) of fn(*args)."""
    t0 = time.perf_counter()
    fn(*args).block_until_ready()
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--m", type=int, default=10_000)
    parser.add_argument("--n", type=int, default=10_000)
    parser.add_argument("--batch_pairs", type=int, default=64)
    parser.add_argument("--batch_len", type=int, default=1024)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--backend", choices=["rows", "scan"], default="rows")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from globalign_jax.config import resolve_scheme
    from globalign_jax.ops import fill_rows, fill_scan
    from globalign_jax.utils.platform import (
        enable_compilation_cache,
        require_gpu,
    )

    try:
        kind = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)

    scheme = resolve_scheme("ACGT", "ACGT")
    consts = (
        jnp.asarray(scheme.costing.values),
        jnp.int32(scheme.alphabet.gap_id),
        jnp.int32(scheme.gap_open_cost),
    )
    fill_batch = (
        fill_rows.row_fill_batch if args.backend == "rows"
        else fill_scan.wavefront_fill_batch
    )
    rng = np.random.default_rng(0)

    def tokens(B, m, n):
        ta = np.zeros((B, m + 1), np.int32)
        tb = np.zeros((B, n + 1), np.int32)
        ta[:, 1:] = rng.integers(0, 4, (B, m))
        tb[:, 1:] = rng.integers(0, 4, (B, n))
        return (jnp.asarray(ta), jnp.asarray(tb), *consts,
                jnp.full((B,), m, jnp.int32), jnp.full((B,), n, jnp.int32))

    @jax.jit
    def cost(*a):
        return fill_batch(*a, want_moves=False).final3.min(axis=-1)

    out = {"backend": args.backend, "device_kind": kind, "card": card}
    arms = {
        "single": (1, args.m, args.n),
        "batch": (args.batch_pairs, args.batch_len, args.batch_len),
    }
    for name, (B, m, n) in arms.items():
        first, steady = _time_calls(cost, tokens(B, m, n), args.repeats)
        out[name] = {
            "pairs": B, "m": m, "n": n,
            "first_s": first, "steady_s": steady,
            "cells_per_s": B * m * n / steady,
            "us_per_row": steady / m * 1e6,
        }
    out["metric"] = f"GCUPS_{args.m // 1000}kb_affine_fill"
    out["value"] = out["single"]["cells_per_s"] / 1e9
    out["unit"] = "GCUPS"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
