"""Dummy method (counterpart of tpu_knn/methods/dummy.py; reference:
include/method/dummy.h, src/method/dummy.cc): a no-op skeleton showing the
method contract. ``doSeqSearch`` delegates to the exact scan (so on an
affine space such as l2 it runs the group-min kernel); otherwise searches
return empty results."""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataStore
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from .base import Method
from .seq_search import SeqSearch


@register_method("dummy")
class DummyMethod(Method):
    name = "dummy"
    supports_range = True

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        self.do_seq_search = pm.get("doSeqSearch", False, bool)
        pm.check_unused()
        self._delegate = SeqSearch(space, Params()) if self.do_seq_search else None

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        if self._delegate is not None:
            self._delegate.create_index(store, params)
            self.data = self._delegate.data

    def knn(self, points, k: int):
        if self._delegate is not None:
            return self._delegate.knn(points, k)
        n = len(points)
        return np.full((n, k), np.inf, np.float32), np.full((n, k), -1, np.int64)

    def range(self, points, radius: float):
        if self._delegate is not None:
            return self._delegate.range(points, radius)
        return [(np.zeros(0, np.int64), np.zeros(0, np.float32)) for _ in range(len(points))]
