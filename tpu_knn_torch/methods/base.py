"""Index-method abstraction (counterpart of tpu_knn/methods/base.py;
reference: include/index.h:30-113).

A Method owns encoded corpus data plus whatever acceleration structure it
builds and answers batched kNN queries. Differences from the reference,
by design:

  * Queries are *batched* host arrays; the batch dimension replaces the
    reference's per-index thread pool.
  * ``add_batch``/``delete_batch`` raise unless the method supports
    incremental maintenance (only sw-graph does in the reference,
    small_world_rand.cc:141-338).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..core.dataset import DataStore, round_up
from ..core.errors import RuntimeNmsError, SpaceIncompatibleError
from ..core.params import Params
from ..spaces.base import Space

#: Distances at or above this are padding/masked sentinels, never results.
RESULT_DIST_CUTOFF = 1e29


def range_cap(max_count: int, n_pad: int) -> int:
    """Result slots per query of the collect pass: the largest count
    rounded up to 128, at most the padded corpus."""
    return min(round_up(int(max_count), 128), n_pad)


def stream_range_results(counts: np.ndarray, data, collect):
    """Shared tail of the streamed two-pass range scan: size the result cap
    from the counts pass (:func:`range_cap`), run the collect pass, and
    slice per-query (ids, dists).
    ``collect(cap)`` returns ([Q, cap] dists, [Q, cap] corpus positions)
    ascending with (+inf, -1) pads. Ids come back in ``data.ids``' int32,
    dists in f32; a query without hits gets two empty arrays."""
    f32 = np.zeros(0, np.float32)
    if counts.max(initial=0) == 0:
        return [(np.zeros(0, np.int32), f32) for _ in range(counts.shape[0])]
    dk, pos = collect(range_cap(counts.max(), data.ids.shape[0]))
    dk, pos = dk.cpu().numpy(), pos.cpu().numpy()
    ids = data.ids.cpu().numpy()
    return [(ids[pos[i, :c]].copy(), dk[i, :c].copy()) for i, c in enumerate(counts)]


class Method:
    name: str = "abstract"
    supports_range: bool = True
    supports_incremental: bool = False

    def __init__(self, space: Space, params: Params | None = None):
        self.space = space
        self.index_params = Params.of(params)
        self.query_params = Params()
        self.data = None  # encoded corpus
        self.store: DataStore | None = None
        #: distance computations performed (reference: query.h:33); a
        #: host int computed from shapes, so reading it never syncs
        self.dist_comps = 0

    # -- lifecycle --
    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        raise NotImplementedError

    def set_query_time_params(self, params: Params | None) -> None:
        self.query_params = Params.of(params)

    # -- queries --
    def knn(self, points: Any, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN. Returns (dists[B,k], ids[B,k]) sorted ascending;
        missing results (k > corpus) have id -1 and dist +inf."""
        raise NotImplementedError

    def range(self, points: Any, radius: float) -> list[tuple[np.ndarray, np.ndarray]]:
        raise SpaceIncompatibleError(f"Range search is not supported by {self.name}!")

    def knn_async(self, points: Any, k: int):
        """Dispatch a kNN batch; return a zero-arg callable that gives
        (dists, ids). Default: synchronous (already materialized)."""
        d, i = self.knn(points, k)
        return lambda: (d, i)

    # -- persistence (reference: index.h:56-63) --
    def save(self, path: str) -> None:
        raise RuntimeNmsError(f"save not supported by {self.name}")

    def load(self, path: str, store: DataStore) -> None:
        raise RuntimeNmsError(f"load not supported by {self.name}")

    # -- persistence state hooks (used by io/persist.py) --
    def state_arrays(self) -> dict:
        """Method-specific index state as host arrays. Default: nothing,
        restore() rebuilds."""
        return {}

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        """Reconstruct from saved state; default rebuilds from the data."""
        self.create_index(store, params)

    def aux_device_arrays(self):
        """Tensors beyond .data that count toward the index footprint
        (memory_usage_bytes). Default: none."""
        return ()

    # -- incremental maintenance --
    def add_batch(self, store: DataStore, new_positions: Sequence[int]) -> None:
        raise RuntimeNmsError(f"{self.name} does not support incremental addition")

    def delete_batch(self, positions: Sequence[int], strategy: str = "none") -> None:
        raise RuntimeNmsError(f"{self.name} does not support deletion")

    # -- helpers --
    def _finalize_knn(self, dists, ids) -> tuple[np.ndarray, np.ndarray]:
        """Convert results to host numpy, mapping masked sentinels to
        (+inf, -1)."""
        d = np.asarray(dists)
        i = np.asarray(ids)
        bad = d >= RESULT_DIST_CUTOFF
        d = np.where(bad, np.inf, d)
        i = np.where(bad, -1, i)
        return d, i
