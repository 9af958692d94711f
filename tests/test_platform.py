"""One engine on every platform: the backend function, the compile cache
location, the ``--platform`` option, and the dispatch sites, which all
reach the XLA row scan whatever platform the engine reports."""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from globalign_jax.utils import platform

REPO = Path(__file__).resolve().parents[1]


def test_engine_platform_is_cpu_here():
    assert platform.engine_platform() == "cpu"


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compilation_cache_dir() == tmp_path


def test_cache_dir_default_is_in_checkout_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.compilation_cache_dir()
    assert path == platform.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_cache_dir_stable_across_calls(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = platform.compilation_cache_dir()
    assert all(platform.compilation_cache_dir() == first for _ in range(3))
    assert not str(first).startswith(tempfile.gettempdir())


def test_enable_cache_on_gpu_uses_env_dir(monkeypatch, tmp_path):
    """On an accelerator the cache goes to $JAX_COMPILATION_CACHE_DIR and
    nowhere else (this process's cache was settled by earlier compiles,
    so pointing the config elsewhere and back is harmless)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(platform, "engine_platform", lambda: "gpu")
    monkeypatch.setattr(platform, "_CACHE_ENABLED", False)
    monkeypatch.delenv("GLOBALIGN_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    try:
        platform.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")
        assert (tmp_path / "xla").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_cache_skips_cpu(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(platform, "_CACHE_ENABLED", False)
    monkeypatch.delenv("GLOBALIGN_NO_CACHE", raising=False)
    platform.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not platform._CACHE_ENABLED


def _parse(module, value):
    from globalign_jax import batch_cli, cli

    if module == "cli":
        return cli.build_parser().parse_args(
            ["--seq_1", "A", "--seq_2", "C", "--platform", value]
        )
    return batch_cli.build_parser().parse_args(
        ["--pairs_tsv", "x.tsv", "-o", "o.tsv", "--platform", value]
    )


@pytest.mark.parametrize("module", ["cli", "batch_cli"])
@pytest.mark.parametrize("value", ["cpu", "gpu"])
def test_platform_option_parses(module, value):
    assert _parse(module, value).platform == value


@pytest.mark.parametrize("module", ["cli", "batch_cli"])
def test_platform_option_offers_cpu_and_gpu_only(module):
    from globalign_jax import batch_cli, cli

    parser = (cli if module == "cli" else batch_cli).build_parser()
    action = parser._option_string_actions["--platform"]
    assert list(action.choices) == ["cpu", "gpu"]
    with pytest.raises(SystemExit):
        _parse(module, "metal")


def _dna():
    rng = np.random.default_rng(4)
    return [
        ("".join(rng.choice(list("ACGT"), m)),
         "".join(rng.choice(list("ACGT"), n)))
        for m, n in [(40, 33), (9, 20), (35, 35)]
    ]


def _site(name, cpu_mesh):
    """Run one dispatch site on the DNA pairs; return its costs."""
    from globalign_jax import align_pairs, resolve_scheme
    from globalign_jax.models.gotoh import GotohAligner
    from globalign_jax.ops.linear_tb import align_blocked
    from globalign_jax.parallel import mesh as mesh_mod
    from globalign_jax.parallel.seqpar import make_strip_mesh, sharded_pair_cost
    from globalign_jax.utils.tokenize import encode_padded

    pairs = _dna()
    s = resolve_scheme("ACGT", "ACGT")
    a = s.alphabet
    consts = (s.costing.values, a.gap_id, s.gap_open_cost)
    if name == "aligner_cost":
        return [GotohAligner(s).cost(*p) for p in pairs]
    if name == "aligner_align":
        return [GotohAligner(s).align(*p).cost for p in pairs]
    if name == "aligner_blocked":
        return [GotohAligner(s, moves_budget_bytes=1).align(*p).cost
                for p in pairs]
    if name == "align_pairs_cost":
        return [r.cost for r in align_pairs(pairs, with_traceback=False)]
    if name == "align_pairs_traceback":
        return [r.cost for r in align_pairs(pairs)]
    if name == "align_blocked_mesh":
        return [
            align_blocked(
                encode_padded(a, x, len(x)),
                jnp.asarray(encode_padded(a, y, len(y))), *consts, x, y,
                block_rows=8, mesh=cpu_mesh,
            ).cost
            for x, y in pairs
        ]
    if name == "sharded_pair_cost":
        return [
            int(sharded_pair_cost(
                make_strip_mesh(), encode_padded(a, x, len(x)),
                encode_padded(a, y, len(y)), *consts, block_rows=8,
            ).min())
            for x, y in pairs
        ]
    tok_a = np.stack([encode_padded(a, x, 40) for x, _ in pairs])
    tok_b = np.stack([encode_padded(a, y, 35) for _, y in pairs])
    lens = [np.array([len(p[k]) for p in pairs], np.int32) for k in (0, 1)]
    fn = (
        mesh_mod.sharded_fill_costs if name == "sharded_fill_costs"
        else lambda *args: mesh_mod.sharded_fill_moves(*args)[0]
    )
    return fn(cpu_mesh, tok_a, tok_b, *consts, *lens).min(axis=-1).tolist()


SITES = [
    "aligner_cost", "aligner_align", "aligner_blocked", "align_pairs_cost",
    "align_pairs_traceback", "align_blocked_mesh", "sharded_pair_cost",
    "sharded_fill_costs", "sharded_fill_moves",
]


@pytest.mark.parametrize("site", SITES)
def test_dispatch_site_takes_xla_path_on_gpu(site, cpu_mesh, monkeypatch):
    """With the engine's platform reported as "gpu", every dispatch site
    still traces the row scan's prefix-min and returns the oracle cost."""
    from globalign_jax import resolve_scheme

    from .oracle import oracle_cost

    monkeypatch.setattr(platform, "engine_platform", lambda: "gpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("GLOBALIGN_NO_CACHE", "1")
    traced = []
    real_cummin = jax.lax.cummin

    def spy(x, *args, **kw):
        traced.append(x.shape)
        return real_cummin(x, *args, **kw)

    monkeypatch.setattr(jax.lax, "cummin", spy)
    jax.clear_caches()
    got = _site(site, cpu_mesh)
    s = resolve_scheme("ACGT", "ACGT")
    want = [oracle_cost(x, y, s.costing, s.gap_open_cost) for x, y in _dna()]
    assert got == want
    assert traced, f"{site} did not reach the row scan"


def test_package_holds_no_device_specific_kernels():
    """No experimental-kernel import, kernel-choosing parameter or platform
    branch is left in the engine: one XLA program family serves every
    platform."""
    import ast

    for path in (REPO / "globalign_jax").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith(
                    "jax.experimental"), path
            elif isinstance(node, ast.Import):
                assert not any(
                    a.name.startswith("jax.experimental") for a in node.names
                ), path
            elif isinstance(node, ast.arguments):
                names = {a.arg for a in node.args + node.kwonlyargs}
                assert "interpret" not in names, path
                assert not any(n.startswith("use_") for n in names), path
            elif path.name != "platform.py" and isinstance(
                node, ast.Attribute
            ):
                # jax.devices()[k].platform / jax.default_backend(): the
                # platform is read in utils/platform.py only.
                assert node.attr != "default_backend", path
                v = node.value
                assert not (
                    node.attr == "platform"
                    and isinstance(v, ast.Subscript)
                    and isinstance(v.value, ast.Call)
                ), path
