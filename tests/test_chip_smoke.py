"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and each
of its phases, called at a tiny size on the CPU device, passes its own
checks (the on-card run uses the same code at real sizes)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _passed(checks):
    assert checks and all(ok for _, ok in checks), checks


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert out.startswith("card: ")


def test_main_four_refuses_cpu(capsys):
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_device_phase_fails_on_cpu():
    checks = dict(chip_smoke.phase_device())
    assert checks["JAX runs on a GPU"] is False


def test_make_pairs_reproducible():
    a = chip_smoke.make_pairs(4, 30, 60, chip_smoke.DNA, seed=3)
    b = chip_smoke.make_pairs(4, 30, 60, chip_smoke.DNA, seed=3)
    assert a == b
    assert all(30 <= len(x) <= 60 for x, _ in a)


def test_device_busy_seconds_without_gpu_planes(tmp_path):
    assert chip_smoke.device_busy_seconds(tmp_path) == (0.0, [])


def test_card_line_is_text():
    assert isinstance(chip_smoke.card_line(), str)


@pytest.mark.parametrize("phase", [
    "cli", "batch_dna", "batch_protein", "long_pair", "huge_pair",
])
def test_phase_passes_at_tiny_size(phase, tmp_path):
    cs = chip_smoke
    if phase == "cli":
        checks = cs.phase_cli(tmp_path, prot_len=25)
    elif phase == "batch_dna":
        pairs = cs.make_pairs(10, 30, 70, cs.DNA, seed=1)
        checks = cs.phase_batch(tmp_path, "dna", pairs, {}, n_cpu=4)
    elif phase == "batch_protein":
        pairs = cs.make_pairs(6, 20, 50, cs.PROTEIN, seed=2, divergence=0.3)
        checks = cs.phase_batch(
            tmp_path, "protein", pairs, {"scoring_mat_name": "BLOSUM62"},
            n_cpu=3,
        )
    elif phase == "long_pair":
        checks = cs.phase_long_pair(
            n=90, scan_rows=16, scan_widths=(16, 48), profile=False
        )
    else:
        checks = cs.phase_huge_pair(n=200)
    _passed(checks)


def test_four_phase_on_virtual_mesh(cpu_mesh):
    cs = chip_smoke
    pairs = cs.make_pairs(9, 30, 60, cs.DNA, seed=1)
    huge = cs.make_pairs(1, 150, 150, cs.DNA, seed=30)[0]
    _passed(cs.phase_four(pairs, huge, count=4))


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main(["--m", "8", "--n", "8"]) != 0
    assert "{" not in capsys.readouterr().out
