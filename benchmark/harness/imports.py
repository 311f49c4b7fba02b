"""The check that nothing the benchmark runs loads JAX or the JAX package.

Module names are compared by their top-level name whole (the part before
the first dot): ``kmerutils_tpu_torch``, the program, begins with
``kmerutils_tpu``, the JAX package, and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kmerutils_tpu"})


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
