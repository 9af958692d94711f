"""Live conformance fuzz against the actual reference implementation.

The strongest parity evidence available in this environment: run the
REAL reference package (pure Python, /root/reference/src) in a
subprocess on randomized inputs across every scheme family and assert
bit-identical (score, cost) from our engine.  Alignment strings are NOT
compared — the reference tie-breaks with unseeded random.choice
(reference globaligner.py:598-672; SURVEY.md "behavioral quirks"), so
only score/cost are deterministic there.  Skips cleanly when the
reference tree is absent (CI).

Complements test_conformance.py (the reference's own golden vectors,
which pin exact values without needing the reference installed).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REF_SRC = Path("/root/reference/src")

pytestmark = pytest.mark.skipif(
    not (REF_SRC / "globalign" / "globaligner.py").exists(),
    reason="reference tree not available",
)

_RUNNER = r"""
import json, sys
import globalign
# Guard against the compat-shim shadowing bug: `python -c` puts the
# CWD on sys.path[0], and /root/repo/globalign is a drop-in shim of
# this very engine — importing it here would make every "live
# reference" assertion circular self-parity.  The subprocess therefore
# runs with cwd inside the reference tree and verifies the import.
assert globalign.__file__.startswith(sys.argv[1]), globalign.__file__
from globalign.globaligner import find_global_alignment

out = []
for case in json.load(sys.stdin):
    res = find_global_alignment(**case)
    out.append({"score": res.score, "cost": res.cost})
json.dump(out, sys.stdout)
"""


def _ref_env() -> dict:
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["PYTHONPATH"] = str(REF_SRC)
    return env


def _reference_results(cases: list[dict]) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(REF_SRC)],
        input=json.dumps(cases),
        capture_output=True,
        text=True,
        env=_ref_env(),
        cwd=str(REF_SRC),
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


def _random_cases(rng: np.random.Generator, n_cases: int) -> list[dict]:
    """Randomized pairs across all four scheme-resolution branches."""
    cases = []
    for k in range(n_cases):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(1, 40))
        if k % 4 == 0:
            # Protein pair on a named BLOSUM (branch a).
            letters = list("ARNDCQEGHILKMFPSTWYV")
            extra = {
                "scoring_mat_name": ["BLOSUM62", "BLOSUM50"][k % 8 == 0]
            }
        elif k % 4 == 1:
            # Simple costing scheme (branch c).
            letters = list("ACGT")
            extra = {
                "mismatch_cost": int(rng.integers(1, 9)),
                "gap_open_cost": int(rng.integers(0, 6)),
                "gap_extension_cost": int(rng.integers(1, 6)),
            }
        elif k % 4 == 2:
            # Simple scoring scheme (branch d, explicit).
            letters = list("ACGT")
            extra = {
                "match_score": int(rng.integers(1, 6)),
                "mismatch_score": -int(rng.integers(1, 6)),
                "gap_open_score": -int(rng.integers(0, 5)),
                "gap_extension_score": -int(rng.integers(1, 5)),
            }
        else:
            # All defaults (branch d).
            letters = list("ACGT")
            extra = {}
        cases.append(
            {
                "seq_1": "".join(rng.choice(letters, m)),
                "seq_2": "".join(rng.choice(letters, n)),
                **extra,
            }
        )
    return cases


def test_score_cost_parity_with_live_reference():
    from globalign_jax import find_global_alignment

    rng = np.random.default_rng(2026)
    cases = _random_cases(rng, 24)
    want = _reference_results(cases)
    for case, ref in zip(cases, want):
        res = find_global_alignment(**case)
        assert (res.score, res.cost) == (ref["score"], ref["cost"]), (
            case,
            (res.score, res.cost),
            ref,
        )
        # Stronger than the reference's own asserts: our deterministic
        # alignment must PRICE to the reported cost (the reference cannot
        # promise this for its random tie-breaks; SURVEY.md quirk 2).
        from globalign_jax.ops.traceback import alignment_cost
        from globalign_jax.utils.matrices import SubstitutionMatrix

        costing = SubstitutionMatrix.from_nested_dict(res.costing_mat)
        assert (
            alignment_cost(
                res.seq_1_aligned, res.seq_2_aligned, costing,
                res.gap_open_cost,
            )
            == res.cost
        )


def _write_random_scoring_mat(rng, path, b: int) -> None:
    """Random symmetric scoring matrix over ACGT- with max score b on
    the letter diagonal (the reference's scoring_mat_path contract:
    symmetric + max-on-main-diagonal, start.py:291-318).  Odd b makes
    the score->cost transform's deletion/insertion deltas asymmetric
    (Δd=floor(b/2) != Δi=ceil(b/2)) — exercised deliberately here."""
    letters = list("ACGT-")
    A = len(letters)
    off = rng.integers(-6, 0, size=(A, A))
    mat = np.minimum(off, off.T)
    gap = -int(rng.integers(1, 7))
    mat[-1, :] = gap
    mat[:, -1] = gap
    for i in range(A - 1):
        mat[i, i] = b
    lines = ["   " + "  ".join(letters)]
    for i, ch in enumerate(letters):
        lines.append(ch + " " + " ".join(f"{v:3d}" for v in mat[i]))
    path.write_text("\n".join(lines) + "\n")


def test_parity_custom_matrix_file(tmp_path):
    """Scheme branch (b): custom scoring_mat_path files, odd AND even
    max score (reference start.py:291-318)."""
    from globalign_jax import find_global_alignment

    rng = np.random.default_rng(41)
    cases = []
    for k, b in enumerate([2, 3, 4, 5, 7, 8]):
        p = tmp_path / f"mat_{b}.mtx"
        _write_random_scoring_mat(rng, p, b)
        m = int(rng.integers(1, 40))
        n = int(rng.integers(1, 40))
        cases.append({
            "seq_1": "".join(rng.choice(list("ACGT"), m)),
            "seq_2": "".join(rng.choice(list("ACGT"), n)),
            "scoring_mat_path": str(p),
        })
    want = _reference_results(cases)
    for case, ref in zip(cases, want):
        res = find_global_alignment(**case)
        assert (res.score, res.cost) == (ref["score"], ref["cost"]), (
            case, (res.score, res.cost), ref,
        )


def test_parity_at_reference_envelope():
    """ONE live case at the boundary of the reference's input envelope
    (m*n < 2e7, reference start.py:213,361-376): 4.2 kb x 4.4 kb =
    18.48e6 cells — the regime where int headroom and boundary
    accumulation would actually surface.  The reference needs ~30 s of
    pure-Python DP here (measured ~1.6 us/cell); budgeted inside the
    subprocess timeout."""
    from globalign_jax import find_global_alignment

    rng = np.random.default_rng(404)
    case = {
        "seq_1": "".join(rng.choice(list("ACGT"), 4200)),
        "seq_2": "".join(rng.choice(list("ACGT"), 4400)),
    }
    want = _reference_results([case])[0]
    res = find_global_alignment(**case)
    assert (res.score, res.cost) == (want["score"], want["cost"]), (
        (res.score, res.cost), want,
    )


def test_envelope_boundary_accept_and_refuse():
    """The reference refuses m*n just over 2e7 (check_seq_lengths,
    start.py:361-376, applied in validate_and_transform_args — its
    CLI/entry validation layer).  Drop-in parity: our COMPAT SHIM's
    validate_and_transform_args refuses with the byte-identical
    message.  The NATIVE engine deliberately extends the envelope
    (config.DEFAULT_MAX_SEQ_LEN_PROD = 2e12; the 2e7 cap existed for
    the reference's Python fill) — it must ACCEPT just-over-2e7 inputs
    and still refuse past its own cap with the same error shape.  The
    just-under ACCEPT leg runs only our engine (the reference's
    ~1.6 us/cell Python fill would need ~32 s for a second
    envelope-scale case; its accept behavior at scale is pinned by
    test_parity_at_reference_envelope)."""
    from globalign_jax import find_global_alignment
    from globalign_jax.config import check_seq_lengths

    rng = np.random.default_rng(405)
    over = {
        "seq_1": "".join(rng.choice(list("ACGT"), 4473)),
        "seq_2": "".join(rng.choice(list("ACGT"), 4473)),
    }
    assert 4473 * 4473 >= 20_000_000
    runner = (
        "import json, sys\n"
        "import globalign\n"
        "assert globalign.__file__.startswith(sys.argv[1])\n"
        "from globalign.start import validate_and_transform_args\n"
        "case = json.load(sys.stdin)\n"
        "try:\n"
        "    validate_and_transform_args(**case)\n"
        "    print('NO ERROR')\n"
        "except RuntimeError as e:\n"
        "    print(str(e))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", runner, str(REF_SRC)],
        input=json.dumps(over), capture_output=True, text=True,
        env=_ref_env(), cwd=str(REF_SRC),
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_msg = proc.stdout.strip()
    assert "too long" in ref_msg

    # Drop-in shim: byte-identical refusal at the reference's cap.
    from globalign.start import validate_and_transform_args as shim_validate

    with pytest.raises(RuntimeError) as exc:
        shim_validate(**over)
    assert str(exc.value) == ref_msg

    # Native engine: same error SHAPE at its own (lifted) cap.
    with pytest.raises(RuntimeError, match="too long"):
        check_seq_lengths("A" * 2_000_000, "C" * 1_000_001, 2 * 10**12)

    # Just under the cap: our engine accepts and aligns (cost prices).
    under = {
        "seq_1": "".join(rng.choice(list("ACGT"), 4472)),
        "seq_2": "".join(rng.choice(list("ACGT"), 4472)),
    }
    assert 4472 * 4472 < 20_000_000
    res = find_global_alignment(**under)
    assert res.cost >= 0
    from globalign_jax.ops.traceback import alignment_cost
    from globalign_jax.utils.matrices import SubstitutionMatrix

    costing = SubstitutionMatrix.from_nested_dict(res.costing_mat)
    assert (
        alignment_cost(
            res.seq_1_aligned, res.seq_2_aligned, costing,
            res.gap_open_cost,
        )
        == res.cost
    )


def test_parity_fasta_input(tmp_path):
    """FASTA-file input path against the live reference (reference
    start.py:614-688): multi-line records, lower-case upcasing, first
    two records taken."""
    from globalign_jax import find_global_alignment

    fa = tmp_path / "pair.fasta"
    fa.write_text(
        ">first record | demo\n"
        "acgtacGTAC\n"
        "GTACGT\n"
        ">second record\n"
        "ttgacaTGA\n"
        ">third record is ignored\n"
        "AAAA\n"
    )
    cases = [
        {"input_fasta": str(fa)},
        {"input_fasta": str(fa), "scoring_mat_name": "BLOSUM62"},
        {"input_fasta": str(fa), "mismatch_cost": 7, "gap_open_cost": 2,
         "gap_extension_cost": 4},
    ]
    want = _reference_results(cases)
    for case, ref in zip(cases, want):
        res = find_global_alignment(**case)
        assert (res.score, res.cost) == (ref["score"], ref["cost"]), (
            case, (res.score, res.cost), ref,
        )


def test_parity_long_pairs():
    """A few 200-500-length pairs (the reference supports ~4.4 kb; the
    short fuzz never leaves length 40)."""
    from globalign_jax import find_global_alignment

    rng = np.random.default_rng(97)
    prot = list("ARNDCQEGHILKMFPSTWYV")
    cases = [
        {"seq_1": "".join(rng.choice(list("ACGT"), 317)),
         "seq_2": "".join(rng.choice(list("ACGT"), 489))},
        {"seq_1": "".join(rng.choice(prot, 251)),
         "seq_2": "".join(rng.choice(prot, 203)),
         "scoring_mat_name": "BLOSUM62"},
        {"seq_1": "".join(rng.choice(list("ACGT"), 500)),
         "seq_2": "".join(rng.choice(list("ACGT"), 211)),
         "mismatch_cost": 5, "gap_open_cost": 3, "gap_extension_cost": 2},
    ]
    want = _reference_results(cases)
    for case, ref in zip(cases, want):
        res = find_global_alignment(**case)
        assert (res.score, res.cost) == (ref["score"], ref["cost"]), (
            case, (res.score, res.cost), ref,
        )
