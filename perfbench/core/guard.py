"""What a run may load, and where the program must come from.

The port's package name begins with the reference package's, so modules
are compared by their whole top-level name, the part before the first
dot: ``intro_tc_vae_tpu_torch.train`` is the port, ``intro_tc_vae_tpu``
and ``intro_tc_vae_tpu.ops`` are not allowed."""

from __future__ import annotations

import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "intro_tc_vae_tpu"})
PROGRAM = "intro_tc_vae_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """Sorted names in ``modules`` (default ``sys.modules``) whose whole
    top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if top_level(name) in FORBIDDEN)


def import_program(root: Path):
    """Import the port from the checkout at ``root`` and nowhere else;
    raises ``ImportError`` when the checkout does not hold it."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import importlib

    pkg = importlib.import_module(PROGRAM)
    where = Path(pkg.__file__).resolve().parent.parent
    if where != root.resolve():
        raise ImportError(f"{PROGRAM} comes from {where}, not from the checkout {root}")
    return pkg
