"""Smoke run of the aligner's main path on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases 1-5 below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

Phases on one GPU, each through the entry points a user calls:

1. device: JAX runs on a GPU (exit non-zero otherwise, printing no result);
2. CLI, single pair: the tutorial's golden pair, and a BLOSUM62 FASTA pair
   written with ``-o`` whose score and cost equal the CPU engine's;
3. served batch through ``batch_cli.main`` / ``BatchRunner``: 1,024 DNA
   pairs around 1 kb and 256 BLOSUM62 protein pairs of 200-500 residues,
   cost-only and with traceback;
4. one 10 kb DNA pair: ``GotohAligner.cost`` and ``find_global_alignment``,
   with the row scan's per-row cost, its scaling in n and the device's
   busy share from a ``jax.profiler`` trace;
5. one 30 kb DNA pair aligned in linear space (``align_blocked``).

``--four`` runs only the paths that span cards, each beside the one-card
result it must equal: ``align_pairs(mesh=...)`` on the phase-3 DNA set and
``align_blocked(mesh=...)`` on the 30 kb pair.

Every comparison is exact (costs, scores and alignment strings are
integers and characters).  The CPU engine runs in the same process under
``jax.default_device``.  Inputs come from ``utils/random_seqs`` with fixed
seeds.  Each phase prints its checks and wall times (first call =
compile + run, second = steady) on lines of its own; the last line of
standard output is one JSON object, printed only when every check passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

Check = tuple[str, bool]

DNA = list("ACGT")
PROTEIN = list("ARNDCQEGHILKMFPSTWYV")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    cmd = [
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ]
    try:
        out = subprocess.run(
            cmd, capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return " | ".join(out.splitlines())


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _report(phase: str, checks: list[Check]) -> list[Check]:
    for name, ok in checks:
        say(f"[{phase}] {'PASS' if ok else 'FAIL'} {name}")
    return checks


@contextlib.contextmanager
def _pinned_random(seed: int):
    """``random_seqs`` reseeds Python's generator from the OS for its
    substitution letters (as the reference does); pin those draws to
    ``seed`` so every input is reproducible."""
    orig = random.seed
    random.seed = lambda a=None, **kw: orig(seed if a is None else a, **kw)
    try:
        yield
    finally:
        random.seed = orig


def make_pairs(n, lo, hi, alphabet, seed, divergence=0.1):
    """``n`` related pairs: seq_1 of length uniform in [lo, hi], seq_2 an
    edit of it within 5% of its length."""
    from globalign_jax.utils.random_seqs import draw_two_random_seqs

    pairs = []
    with _pinned_random(seed):
        for k in range(n):
            random.seed(seed + k)
            m = random.randint(lo, hi)
            d = max(1, m // 20)
            pairs.append(draw_two_random_seqs(
                alphabet, m, m, m - d, m + d, divergence,
                seed_1=seed + k, seed_2=seed + n + k,
            ))
    return pairs


def phase_device(count: int = 1) -> list[Check]:
    import jax

    d = jax.devices()
    say(
        f"[device] platform={d[0].platform} kind={d[0].device_kind} "
        f"count={len(d)} jax={jax.__version__}"
    )
    return _report("device", [
        ("JAX runs on a GPU", d[0].platform == "gpu"),
        (f"at least {count} device(s)", len(d) >= count),
    ])


def phase_cli(tmp: Path, prot_len: int = 300) -> list[Check]:
    import jax

    from globalign_jax import cli, find_global_alignment

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, t1 = _timed(lambda: cli.main(["--seq_1", "ACGT", "--seq_2", "AGT"]))
    out = buf.getvalue()
    checks = [(
        "tutorial pair: ACGT / | || / A-GT, score 0, cost 7",
        "ACGT\n| ||\nA-GT" in out and "score: 0" in out and "cost: 7" in out,
    )]

    s1, s2 = make_pairs(1, prot_len, prot_len, PROTEIN, seed=7, divergence=0.3)[0]
    fasta = tmp / "pair.fa"
    fasta.write_text(f">p1\n{s1}\n>p2\n{s2}\n")
    report = tmp / "pair_report.txt"
    args = ["-i", str(fasta), "--scoring_mat_name", "BLOSUM62",
            "-o", str(report)]
    _, t2 = _timed(lambda: cli.main(args))
    text = report.read_text()
    got = (
        int(text.split("score: ")[1].split("\n")[0]),
        int(text.split("cost: ")[1].split("\n")[0]),
    )
    with jax.default_device(_cpu()):
        ref = find_global_alignment(
            seq_1=s1, seq_2=s2, scoring_mat_name="BLOSUM62"
        )
    checks.append((
        f"BLOSUM62 {len(s1)}x{len(s2)} FASTA -o report: (score, cost) "
        f"{got} == CPU {(ref.score, ref.cost)}",
        got == (ref.score, ref.cost),
    ))
    say(f"[cli] tutorial pair {t1:.3f} s; BLOSUM62 pair {t2:.3f} s "
        "(each a first call: compile + run)")
    return _report("cli", checks)


def _read_tsv(path: Path):
    rows = {}
    for line in path.read_text().splitlines():
        f = line.split("\t")
        rows[int(f[0])] = (int(f[1]), int(f[2]), *f[3:])
    return [rows[k] for k in sorted(rows)]


def _run_batch_cli(tmp, tag, pairs, extra):
    from globalign_jax import batch_cli

    tsv = tmp / f"{tag}.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in pairs))
    times = []
    for rep in range(2):
        out = tmp / f"{tag}_{rep}.out.tsv"
        argv = ["--pairs_tsv", str(tsv), "-o", str(out), "--fresh", *extra]
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            _, dt = _timed(lambda: batch_cli.main(argv))
        times.append(dt)
    # Per-phase wall seconds of the steady run, from the runner's log.
    phases: dict = {}
    for line in log.getvalue().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        for k, v in rec.get("phase_seconds", {}).items():
            phases[k] = round(phases.get(k, 0.0) + v, 4)
    return _read_tsv(out), times, phases


def phase_batch(tmp: Path, tag: str, pairs, scheme_kwargs: dict,
                n_cpu: int = 64) -> list[Check]:
    """Served batch, cost-only then traceback; CPU engine on a sample."""
    import jax

    from globalign_jax import align_pairs, resolve_scheme
    from globalign_jax.batch import DEFAULT_BUCKET_QUANTUM, bucket_length
    from globalign_jax.ops.traceback import alignment_cost

    extra = []
    for k, v in scheme_kwargs.items():
        extra += [f"--{k}", str(v)]
    cells = sum(len(a) * len(b) for a, b in pairs)
    cost_rows, t_cost, ph_cost = _run_batch_cli(
        tmp, f"{tag}_cost", pairs, extra
    )
    tb_rows, t_tb, ph_tb = _run_batch_cli(
        tmp, f"{tag}_tb", pairs, extra + ["--with_traceback"]
    )
    for mode, t, ph in (("cost-only", t_cost, ph_cost),
                        ("traceback", t_tb, ph_tb)):
        say(f"[{tag}] {mode}: {len(pairs)} pairs, {cells} cells; first "
            f"{t[0]:.3f} s, steady {t[1]:.3f} s = "
            f"{len(pairs) / t[1]:.1f} pairs/s, {cells / t[1]:.4g} cells/s; "
            f"steady phases {ph}")

    scheme = resolve_scheme(
        "".join(a for a, _ in pairs), "".join(b for _, b in pairs),
        **scheme_kwargs,
    )
    repriced = [
        alignment_cost(r[2], r[4], scheme.costing, scheme.gap_open_cost)
        for r in tb_rows
    ]
    checks = [
        (f"{len(pairs)} rows in each mode",
         len(cost_rows) == len(tb_rows) == len(pairs)),
        ("every alignment re-prices to its reported cost",
         repriced == [r[0] for r in tb_rows]),
        ("cost-only (cost, score) == traceback (cost, score)",
         [r[:2] for r in cost_rows] == [r[:2] for r in tb_rows]),
    ]

    # A sample drawn across buckets, re-aligned by the CPU engine.
    def key(i):
        a, b = pairs[i]
        return (bucket_length(len(a), DEFAULT_BUCKET_QUANTUM),
                bucket_length(len(b), DEFAULT_BUCKET_QUANTUM), i)

    order = sorted(range(len(pairs)), key=key)
    k = min(n_cpu, len(pairs))
    sample = [order[j * len(order) // k] for j in range(k)]
    with jax.default_device(_cpu()):
        ref = align_pairs(
            [pairs[i] for i in sample], with_traceback=True, **scheme_kwargs
        )
    got = [tb_rows[i] for i in sample]
    want = [
        (r.cost, r.score, r.seq_1_aligned, r.middle_part, r.seq_2_aligned)
        for r in ref
    ]
    n_buckets = len({key(i)[:2] for i in sample})
    checks.append((
        f"{k} sampled pairs over {n_buckets} buckets string-identical to "
        "the CPU engine",
        [tuple(r) for r in got] == want,
    ))
    return _report(tag, checks)


def device_busy_seconds(trace_dir: Path) -> tuple[float, list[str]]:
    """Union of GPU event intervals in a jax.profiler trace (seconds),
    with the names of the device lines read.  Stream lines are preferred
    over derived lines that span whole modules."""
    from jax.profiler import ProfileData

    files = sorted(trace_dir.rglob("*.xplane.pb"))
    if not files:
        return 0.0, []
    data = ProfileData.from_file(str(files[-1]))
    spans, names = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            names.append(f"{plane.name}:{ln.name}")
            spans += [(e.start_ns, e.end_ns) for e in ln.events]
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy / 1e9, names


def _row_scan_seconds(m: int, n: int, reps: int = 3) -> float:
    """Steady wall seconds of one cost-only row fill of an m x n pair."""
    import jax.numpy as jnp
    import numpy as np

    from globalign_jax import resolve_scheme
    from globalign_jax.ops import fill_rows

    rng = np.random.default_rng(m + n)
    ta = jnp.asarray(np.r_[0, rng.integers(0, 4, m)].astype(np.int32))
    tb = jnp.asarray(np.r_[0, rng.integers(0, 4, n)].astype(np.int32))
    s = resolve_scheme("ACGT", "ACGT")
    args = (ta, tb, jnp.asarray(s.costing.values),
            jnp.int32(s.alphabet.gap_id), jnp.int32(s.gap_open_cost))
    fill_rows.row_fill(*args, want_moves=False).final3.block_until_ready()
    best = float("inf")
    for _ in range(reps):
        _, dt = _timed(lambda: fill_rows.row_fill(
            *args, want_moves=False).final3.block_until_ready())
        best = min(best, dt)
    return best


def phase_long_pair(n: int = 10_000, scan_rows: int = 1000,
                    scan_widths=(1000, 10_000), profile: bool = True
                    ) -> list[Check]:
    import jax

    from globalign_jax import find_global_alignment, resolve_scheme
    from globalign_jax.models.gotoh import GotohAligner
    from globalign_jax.ops.traceback import alignment_cost

    s1, s2 = make_pairs(1, n, n, DNA, seed=10)[0]
    m, n2 = len(s1), len(s2)
    scheme = resolve_scheme(s1, s2)
    aligner = GotohAligner(scheme)
    cost1, t1 = _timed(lambda: aligner.cost(s1, s2))
    cost2, t2 = _timed(lambda: aligner.cost(s1, s2))
    say(f"[long] cost-only {m}x{n2}: first {t1:.3f} s, steady {t2:.3f} s = "
        f"{m * n2 / t2:.4g} cells/s, {t2 / m * 1e6:.2f} us per row")
    if profile:
        with tempfile.TemporaryDirectory() as td:
            with jax.profiler.trace(td):
                _, tw = _timed(lambda: aligner.cost(s1, s2))
            busy, names = device_busy_seconds(Path(td))
        say(f"[long] traced cost call: wall {tw:.3f} s, device busy "
            f"{busy:.3f} s = {busy / tw:.3f} of the traced wall and "
            f"{busy / t2:.3f} of the untraced steady wall, "
            f"{busy / m * 1e6:.2f} us device per row; lines {names[:6]}")
    per_row = {
        w: _row_scan_seconds(scan_rows, w) / scan_rows for w in scan_widths
    }
    lo, hi = min(scan_widths), max(scan_widths)
    say("[long] row-scan step vs n: " + ", ".join(
        f"n={w}: {t * 1e6:.2f} us/row" for w, t in per_row.items()
    ) + f"; ratio {per_row[hi] / per_row[lo]:.2f} for {hi / lo:.0f}x n")

    with jax.default_device(_cpu()):
        cpu_cost, tc = _timed(lambda: GotohAligner(scheme).cost(s1, s2))
    res, ta = _timed(lambda: find_global_alignment(seq_1=s1, seq_2=s2))
    say(f"[long] find_global_alignment (first call): {ta:.3f} s; CPU engine "
        f"cost-only: {tc:.3f} s")
    return _report("long", [
        (f"GPU cost {cost1} == CPU engine cost {cpu_cost}",
         cost1 == cost2 == cpu_cost),
        ("find_global_alignment cost == cost-only fill",
         res.cost == cost1),
        ("its strings re-price to its cost",
         alignment_cost(res.seq_1_aligned, res.seq_2_aligned,
                        scheme.costing, scheme.gap_open_cost) == res.cost),
    ])


def _blocked(s1, s2, scheme, mesh=None):
    import jax.numpy as jnp

    from globalign_jax.ops.linear_tb import align_blocked
    from globalign_jax.utils.tokenize import encode_padded

    a = scheme.alphabet
    return align_blocked(
        encode_padded(a, s1, len(s1)), jnp.asarray(encode_padded(a, s2, len(s2))),
        scheme.costing.values, a.gap_id, scheme.gap_open_cost, s1, s2,
        mesh=mesh,
    )


def phase_huge_pair(n: int = 30_000) -> list[Check]:
    from globalign_jax import resolve_scheme
    from globalign_jax.models.gotoh import GotohAligner
    from globalign_jax.ops.traceback import alignment_cost

    s1, s2 = make_pairs(1, n, n, DNA, seed=30)[0]
    scheme = resolve_scheme(s1, s2)
    tb1, t1 = _timed(lambda: _blocked(s1, s2, scheme))
    tb2, t2 = _timed(lambda: _blocked(s1, s2, scheme))
    cost, tc = _timed(lambda: GotohAligner(scheme).cost(s1, s2))
    cells = len(s1) * len(s2)
    say(f"[huge] align_blocked {len(s1)}x{len(s2)}: first {t1:.3f} s, "
        f"steady {t2:.3f} s ({2 * cells / t2:.4g} cells/s over both passes); "
        f"cost-only first call {tc:.3f} s")
    return _report("huge", [
        (f"linear-space cost {tb1.cost} == cost-only fill {cost}",
         tb1.cost == cost and tb1 == tb2),
        ("its strings re-price to its cost",
         alignment_cost(tb1.seq_1_aligned, tb1.seq_2_aligned,
                        scheme.costing, scheme.gap_open_cost) == tb1.cost),
    ])


def phase_four(pairs, huge: tuple[str, str], count: int = 4) -> list[Check]:
    """Batch sharded over ``count`` GPUs and a huge pair striped over
    them, each against the one-GPU result in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from globalign_jax import align_pairs, resolve_scheme
    from globalign_jax.parallel import mesh as mesh_mod
    from globalign_jax.parallel.seqpar import ShardedCheckpointFill
    from globalign_jax.utils.tokenize import encode_padded

    devices = jax.devices()[:count]
    mesh = mesh_mod.make_pair_mesh(devices)
    checks: list[Check] = []
    for tb in (False, True):
        mode = "traceback" if tb else "cost-only"
        one, t1 = _timed(lambda: align_pairs(pairs, with_traceback=tb))
        one, t1b = _timed(lambda: align_pairs(pairs, with_traceback=tb))
        four, t4 = _timed(
            lambda: align_pairs(pairs, with_traceback=tb, mesh=mesh))
        four, t4b = _timed(
            lambda: align_pairs(pairs, with_traceback=tb, mesh=mesh))
        say(f"[four] align_pairs {mode}, {len(pairs)} pairs: 1 GPU first "
            f"{t1:.3f} s steady {t1b:.3f} s; {count} GPUs first {t4:.3f} s "
            f"steady {t4b:.3f} s")
        checks.append((f"{mode}: {count}-GPU results == 1-GPU results",
                       one == four))

    # Where the shards land: one bucket through the sharded jit.
    scheme = resolve_scheme("ACGT", "ACGT")
    a = scheme.alphabet
    chunk = pairs[: 2 * count]
    M = max(len(x) for x, _ in chunk)
    N = max(len(y) for _, y in chunk)
    tok_a = np.stack([encode_padded(a, x, M) for x, _ in chunk])
    tok_b = np.stack([encode_padded(a, y, N) for _, y in chunk])
    lens = [np.array([len(p[k]) for p in chunk], np.int32) for k in (0, 1)]
    shard = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(mesh_mod.BATCH_AXIS))
    final3, moves = mesh_mod._sharded_moves_jit(
        mesh, mesh_mod._put(tok_a, shard), mesh_mod._put(tok_b, shard),
        jnp.asarray(scheme.costing.values), jnp.int32(a.gap_id),
        jnp.int32(scheme.gap_open_cost), mesh_mod._put(lens[0], shard),
        mesh_mod._put(lens[1], shard),
    )
    moves_devs = sorted(s.device.id for s in moves.addressable_shards)
    say(f"[four] sharded moves: device_set {sorted(d.id for d in moves.sharding.device_set)}, "
        f"shards on {moves_devs} of shape "
        f"{moves.addressable_shards[0].data.shape}; finals device_set "
        f"{sorted(d.id for d in final3.sharding.device_set)}")
    checks.append((f"moves shards on {count} distinct devices",
                   len(set(moves_devs)) == count))

    s1, s2 = huge
    hs = resolve_scheme(s1, s2)
    one, t1 = _timed(lambda: _blocked(s1, s2, hs))
    four, t4 = _timed(lambda: _blocked(s1, s2, hs, mesh=mesh))
    four, t4b = _timed(lambda: _blocked(s1, s2, hs, mesh=mesh))
    ctx = ShardedCheckpointFill(
        mesh, encode_padded(hs.alphabet, s2, len(s2)), hs.costing.values,
        hs.alphabet.gap_id, hs.gap_open_cost,
    )
    strip_devs = sorted(s.device.id for s in ctx.tok_b_d.addressable_shards)
    say(f"[four] align_blocked {len(s1)}x{len(s2)}: 1 GPU {t1:.3f} s "
        f"(first call); {count} GPUs first {t4:.3f} s, steady {t4b:.3f} s; "
        f"strips on {strip_devs}")
    checks += [
        (f"striped linear-space alignment == 1-GPU alignment (cost "
         f"{four.cost})", one == four),
        (f"strips on {count} distinct devices",
         len(set(strip_devs)) == count),
    ]
    return _report("four", checks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU paths, each beside its one-GPU result",
    )
    args = parser.parse_args(argv)
    count = 4 if args.four else 1

    import jax

    say(f"card: {card_line()}")
    if not all(ok for _, ok in phase_device(count)):
        print("chip_smoke: no usable GPU; nothing was run", file=sys.stderr)
        return 2
    from globalign_jax.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    dna = make_pairs(1024, 950, 1050, DNA, seed=1)
    checks: list[Check] = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if args.four:
            huge = make_pairs(1, 30_000, 30_000, DNA, seed=30)[0]
            checks += phase_four(dna, huge, count)
        else:
            checks += phase_cli(tmp)
            checks += phase_batch(tmp, "dna", dna, {})
            protein = make_pairs(256, 200, 500, PROTEIN, seed=2, divergence=0.3)
            checks += phase_batch(
                tmp, "protein", protein, {"scoring_mat_name": "BLOSUM62"}
            )
            checks += phase_long_pair()
            checks += phase_huge_pair()
    failed = [name for name, ok in checks if not ok]
    say(f"card: {card_line()}; {len(checks)} checks, {len(failed)} failed, "
        f"{time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed checks: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
