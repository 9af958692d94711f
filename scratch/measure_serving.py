"""Serving throughput on one device: the streaming BatchRunner end to
end (TSV in -> resumable chunks -> bucketed row-scan fills ->
deterministic traceback -> TSV out), wall-clocked at steady state.

Writes a pairs TSV, runs the runner twice (the first run pays the
compiles; the second is the steady-state number) in both cost-only and
traceback modes, and prints one JSON line per mode with pairs/s, cells/s
over true cells, and the aggregated per-phase wall-clock decomposition
(fill vs fetch vs traceback vs blocked) parsed from the runner's chunk
log.

    python scratch/measure_serving.py [npairs] [len] [blosum]

A third argument "blosum" serves PROTEIN pairs under BLOSUM62 instead of
the default simple DNA scheme.
"""

import io
import json
import os
import sys
import tempfile
import time

import numpy as np


def run_once(pairs, with_tb, chunk_pairs=128, scheme_kwargs=None):
    from globalign_jax.runner import BatchRunner

    log = io.StringIO()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.tsv")
        runner = BatchRunner(
            output=out,
            chunk_pairs=chunk_pairs,
            with_traceback=with_tb,
            log=log,
            scheme_kwargs=dict(scheme_kwargs or {}),
        )
        t0 = time.perf_counter()
        stats = runner.run(iter(pairs))
        dt = time.perf_counter() - t0
    phases: dict = {}
    for line in log.getvalue().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        for k, v in rec.get("phase_seconds", {}).items():
            phases[k] = phases.get(k, 0.0) + v
    return stats, dt, phases


def main():
    npairs = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    blosum = "blosum" in sys.argv[3:]
    letters = list("ARNDCQEGHILKMFPSTWYV" if blosum else "ACGT")
    scheme_kwargs = {"scoring_mat_name": "BLOSUM62"} if blosum else {}

    from globalign_jax.utils.platform import enable_compilation_cache

    enable_compilation_cache()

    rng = np.random.default_rng(42)
    # Realistic length jitter inside one bucket quantum band plus a
    # second band, so bucketing does real work.
    pairs = []
    cells = 0
    for _ in range(npairs):
        m = int(rng.integers(int(L * 0.8), L + 1))
        n = int(rng.integers(int(L * 0.8), L + 1))
        pairs.append(
            (
                "".join(rng.choice(letters, m)),
                "".join(rng.choice(letters, n)),
            )
        )
        cells += m * n

    for with_tb in (False, True):
        times = []
        for rep in range(2):
            stats, dt, phases = run_once(
                pairs, with_tb, scheme_kwargs=scheme_kwargs)
            assert stats.pairs == npairs, stats
            times.append(dt)
        steady = times[-1]
        unattributed = steady - sum(phases.values())
        print(
            json.dumps(
                {
                    "metric": (
                        ("serving_traceback" if with_tb else "serving_cost")
                        + ("_blosum62" if blosum else "")
                    ),
                    "pairs": npairs,
                    "len": L,
                    "first_s": round(times[0], 2),
                    "steady_s": round(steady, 2),
                    "pairs_per_s": round(npairs / steady, 1),
                    "gcups": round(cells / steady / 1e9, 2),
                    "phase_seconds": {
                        k: round(v, 3) for k, v in sorted(phases.items())
                    },
                    "unattributed_s": round(unattributed, 2),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
