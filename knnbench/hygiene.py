"""What a benchmark run may not load: the JAX package the port was made
from, and JAX itself. Names are compared by their top-level part (before
the first dot) as a whole, so ``tpu_knn_torch`` passes and ``tpu_knn``,
``tpu_knn.ops`` or ``jax.numpy`` do not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpu_knn"})


def forbidden(modules=None) -> list[str]:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
