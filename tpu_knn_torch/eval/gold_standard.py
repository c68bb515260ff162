"""Gold standard: exact kNN / range answers by sequential scan, with a
binary cache (counterpart of tpu_knn/eval/gold_standard.py; reference:
include/gold_standard.h). The batched SeqSearch scan is the multi-query
parallelism. The ``.npz`` cache holds ``dists`` and ``ids`` as tpu_knn's
does, so a cache either package writes loads in the other."""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataStore
from ..core.errors import DataIOError
from ..core.params import Params
from ..methods.seq_search import SeqSearch


class GoldStandard:
    """Exact answers for a query set against a data store, on the space's
    device."""

    def __init__(self, space, store: DataStore):
        self.space = space
        self.method = SeqSearch(space, Params())
        self.method.create_index(store)
        self.dists: np.ndarray | None = None
        self.ids: np.ndarray | None = None

    def compute_knn(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        self.dists, self.ids = self.method.knn(queries, k)
        return self.dists, self.ids

    def compute_range(self, queries, radius: float):
        return self.method.range(queries, radius)

    # -- cache (gold_standard.h:123-142, 249-289 analog) --
    def save_cache(self, path: str) -> None:
        if self.dists is None:
            raise DataIOError("gold standard not computed yet")
        np.savez(path, dists=self.dists, ids=self.ids)

    @staticmethod
    def load_cache(path: str) -> tuple[np.ndarray, np.ndarray]:
        try:
            z = np.load(path if path.endswith(".npz") else path + ".npz")
        except OSError as e:
            raise DataIOError(f"failed to load gold-standard cache {path}: {e}")
        return z["dists"], z["ids"]
