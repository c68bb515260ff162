"""Deterministic RNG helpers.

The reference seeds a thread-local mt19937 from defaultRandomSeed
(reference: include/utils.h:75-129, src/init.cc:34-35). Here a
module-level default seed mirrors initLibrary(seed=...) and feeds numpy
generators (host data) and ``torch.Generator``s (device draws). The two
give different numbers from one seed: data that must match tpu_knn is
drawn with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_SEED = 0


def set_default_seed(seed: int) -> None:
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed)


def default_seed() -> int:
    return _DEFAULT_SEED


def np_rng(seed: int | None = None) -> np.random.Generator:
    return np.random.default_rng(_DEFAULT_SEED if seed is None else seed)


def torch_generator(seed: int | None = None, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded like :func:`np_rng`."""
    return torch.Generator(device=device).manual_seed(_DEFAULT_SEED if seed is None else seed)
