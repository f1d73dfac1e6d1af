"""The import check: a run that has loaded JAX or the JAX package prints
no result. Module names are compared by their top-level name, whole: the
port's `spcies_tpu_torch` is not the JAX package `spcies_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spcies_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def check() -> None:
    """Raise SystemExit, naming what was found, if any is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        raise SystemExit(3)
