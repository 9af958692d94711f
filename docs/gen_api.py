"""Generate the markdown API reference from docstrings.

Mirrors the reference's quartodoc-generated API pages
(/root/reference/_quarto.yml:35-46) without adding a build-time
dependency: plain introspection over the public modules, one page per
module, emitted into docs/api/.  Run from the repo root:

    python docs/gen_api.py

CI builds the site with mkdocs (see .github/workflows/docs.yml); the
generated pages are committed so the docs are readable in-repo too.
"""

from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

MODULES = [
    "globalign_jax",
    "globalign_jax.api",
    "globalign_jax.config",
    "globalign_jax.batch",
    "globalign_jax.runner",
    "globalign_jax.results",
    "globalign_jax.cli",
    "globalign_jax.batch_cli",
    "globalign_jax.models.gotoh",
    "globalign_jax.ops.fill_scan",
    "globalign_jax.ops.fill_rows",
    "globalign_jax.ops.linear_tb",
    "globalign_jax.ops.traceback",
    "globalign_jax.ops.transforms",
    "globalign_jax.parallel.mesh",
    "globalign_jax.parallel.seqpar",
    "globalign_jax.parallel.multihost",
    "globalign_jax.utils.fasta",
    "globalign_jax.utils.matrices",
    "globalign_jax.utils.random_seqs",
    "globalign_jax.utils.tokenize",
    "globalign_jax.utils.platform",
    "globalign_jax.utils.native",
    "globalign",
]


def _fence(text: str) -> str:
    return "\n".join("    " + ln for ln in text.splitlines())


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc if doc else "*(undocumented)*"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    out = []
    for name, obj in vars(mod).items():
        if names is not None and name not in names:
            continue
        if names is None:
            if name.startswith("_"):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            out.append((name, obj))
    return sorted(out)


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    for name, obj in _public_members(mod):
        kind = "class" if inspect.isclass(obj) else "def"
        try:
            sig = str(inspect.signature(obj))
        except (TypeError, ValueError):
            sig = "(...)"
        lines += [f"## `{name}`", "", "```python", f"{kind} {name}{sig}", "```", ""]
        lines += [_doc(obj), ""]
        if inspect.isclass(obj):
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_") or not callable(meth):
                    continue
                try:
                    msig = str(inspect.signature(meth))
                except (TypeError, ValueError):
                    msig = "(...)"
                lines += [
                    f"### `{name}.{mname}`",
                    "",
                    "```python",
                    f"def {mname}{msig}",
                    "```",
                    "",
                    _doc(meth),
                    "",
                ]
    return "\n".join(lines) + "\n"


def main() -> int:
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root.parent))  # repo root, for in-tree runs
    out_dir = root / "api"
    out_dir.mkdir(exist_ok=True)
    index = ["# API reference", "", "One page per public module:", ""]
    for modname in MODULES:
        page = modname.replace(".", "_") + ".md"
        (out_dir / page).write_text(render_module(modname))
        index.append(f"- [`{modname}`]({page})")
    (out_dir / "index.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} pages to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
