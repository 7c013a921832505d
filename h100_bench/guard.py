"""The check that no module of JAX, or of the JAX package that the port
was made from, is loaded: by whole top-level names, since the port's own
name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gr4_packet_modem_tpu"})
PROGRAM = "gr4_packet_modem_tpu_torch"


def loaded_forbidden(modules=None) -> list[str]:
    """Names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def imported_top_levels(path: Path) -> set[str]:
    """Top-level names that the Python file ``path`` imports (relative
    imports excluded)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


def reference_violations(root: Path | None = None) -> list[str]:
    """Files of ``reference/`` that import the program or anything
    forbidden: the reference takes nothing from the program."""
    root = root or Path(__file__).resolve().parent / "reference"
    bad = []
    for f in sorted(root.rglob("*.py")):
        hit = imported_top_levels(f) & (FORBIDDEN | {PROGRAM})
        if hit:
            bad.append(f"{f.name}: {sorted(hit)}")
    return bad


def check(stage: str) -> None:
    """Raise, naming what was found, if a forbidden module is loaded or
    the reference imports the program."""
    found = loaded_forbidden()
    if found:
        raise RuntimeError(f"{stage}: forbidden modules loaded: {found[:20]}")
    bad = reference_violations()
    if bad:
        raise RuntimeError(f"{stage}: the reference imports the program or JAX: {bad}")
