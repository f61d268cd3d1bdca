"""What the benchmark may load: never JAX, the JAX package ``repro``, nor
the packages only the JAX side needs; and the references never the
program.

Names are compared by their top-level part, whole: ``repro_torch`` is the
program, ``repro`` the JAX package.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "msgpack", "ml_dtypes")
PROGRAM = "repro_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def imported_names(path: Path) -> List[str]:
    """Top-level names of every import statement in a source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module or "").split(".")[0])
    return out


def reference_imports_program() -> List[str]:
    """Files of ``reference/`` that import the program or a forbidden
    package."""
    bad = set(FORBIDDEN) | {PROGRAM}
    return sorted(str(p.name) for p in REFERENCE_DIR.glob("*.py")
                  if bad & set(imported_names(p)))


def check() -> List[str]:
    """Every breach, as lines to print; empty when there is none."""
    out = [f"forbidden module loaded: {m}" for m in loaded_forbidden()]
    out += [f"reference file imports the program or JAX: {f}"
            for f in reference_imports_program()]
    return out
