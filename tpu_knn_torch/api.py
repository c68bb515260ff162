"""Public Index API (counterpart of tpu_knn/api.py; reference:
lib.zig:495-1270).

Preserved semantics:
  * deferred data insertion: add_dense_batch only fills a host-side store;
    the index is materialized on ``device`` by build_index (lib.zig:625-681);
  * auto-build on first query (lib.zig:800, 890, ...);
  * "cosine" canonicalized to "cosinesimil" with reverse aliasing in
    get_space_type (lib.zig:530-533, 1234-1239);
  * validation: l2*/cosine* require dim (lib.zig:351-378);
  * query batches padded to power-of-two buckets, as tpu_knn does.

Ported so far: dense f32, uint8, sparse and string data; every dense space
of tpu_knn (``l2``, ``l1``, ``linf``, ``lp``, ``cosinesimil`` with its alias
``cosine``, ``angulardist``, ``negdotprod``, the KL, Itakura-Saito,
Jensen-Shannon, alpha-beta and Renyi divergences, ``l2sqr_sift`` and
``dummy``), every sparse one (the scalar products with their ``_fast``
and ``_bin_fast`` variants, the Lp family and jaccard), the bit spaces
``bit_hamming`` and ``bit_jaccard`` (0/1 uint8 rows, or packed words
through :meth:`Index.add_bit_batch_packed`), ``word_embed`` (text
lines "word v1 ... vd"; queries may be bare words), the string spaces
``leven`` and ``normleven``, the SQFD spaces and ``sparse_dense_fusion``
(JSON objects through add_string_batch); every method: the exact scan
(``seq_search``/``brute_force``) with every pass-1 precision tier and
every ``precision``, ``dummy``, ``hnsw`` (the default method),
``sw-graph``/``small_world_rand`` (rows added after the build are
absorbed in place, :meth:`Index.delete_batch` removes rows),
``vptree``, ``napp``/``pivot_neighb_invindx`` and ``simple_invindx``;
kNN, async kNN (non-blocking for seq_search/brute_force, hnsw, sw-graph
and napp) and range queries; save/load in tpu_knn's format v3
(io/persist.py), so a file either package writes loads in the other.
Sparse query batches are lists of (ids, values) or SparsePoint, of any
length; string batches lists of str or bytes. ``mesh=`` shards the
corpus over logical shards (parallel/mesh.py) for seq_search/brute_force
(the sharded exact scan, parallel/sharded.py) and hnsw (one subgraph per
shard, parallel/hnsw_sharded.py).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .core.dataset import DataKind, DataStore, DistKind, SparsePoint
from .core.errors import InvalidArgumentError
from .core.params import Params
from .core.registry import canonical_space_name, create_method, create_space
from .utils import tracing
from .utils.logging import log


class QueryResult:
    """ids + distances for one query (reference: lib.zig:380-411)."""

    __slots__ = ("ids", "dists")

    def __init__(self, ids: np.ndarray, dists: np.ndarray):
        self.ids = ids
        self.dists = dists

    def __len__(self):
        return len(self.ids)

    def __repr__(self):
        return f"QueryResult(ids={self.ids.tolist()}, dists={self.dists.tolist()})"


class KnnFuture:
    """Handle for a dispatched-but-unread kNN batch
    (:meth:`Index.knn_query_batch_async`). ``result()`` waits for the
    batch and returns the same (dists, ids) pair ``knn_query_batch``
    would; it is idempotent, and re-raises the error the batch raised.
    It keeps the trace batch id of its dispatch, so that the spans of its
    ``result()`` join the batch's (utils/tracing.py)."""

    __slots__ = ("_materialize", "_value", "_batch")

    def __init__(self, materialize, batch=None):
        self._materialize = materialize
        self._value = None
        self._batch = batch

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        if self._materialize is not None:
            with tracing.batch("api.result", self._batch):
                self._value = self._materialize()
            self._materialize = None
        return self._value


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise InvalidArgumentError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise InvalidArgumentError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


class Index:
    """The user-facing index handle. All tensors of the index live on
    ``device`` (default ``"cuda"``); there is no silent CPU fallback.

    ``mesh``: shard the index over a mesh: an int N (an N-shard mesh of
    ``device``'s type, made at build time) or a parallel.mesh.Mesh.
    Supported methods: hnsw (per-shard subgraphs) and
    seq_search/brute_force (the sharded exact scan). The corpus is
    row-sharded, queries are replicated, the per-shard top-k merges on
    the first shard's device."""

    def __init__(
        self,
        space: str,
        space_params: Params | dict | None = None,
        method: str = "hnsw",
        data_type: DataKind | str = DataKind.DENSE,
        dist_type: DistKind | str = DistKind.FLOAT,
        mesh: Any = None,
        device: str | torch.device = "cuda",
    ):
        if isinstance(data_type, str):
            data_type = DataKind(data_type)
        if isinstance(dist_type, str):
            dist_type = DistKind(dist_type)
        self._requested_space = space
        self.space_name = canonical_space_name(space)
        self.method_name = method
        self.data_type = data_type
        self.dist_type = dist_type
        self.space_params = Params.of(space_params)
        self._validate_create_inputs()
        self.device = _resolve_device(device)
        self.space = create_space(self.space_name, self.space_params, device=self.device)
        if self.space.data_kind is not data_type:
            raise InvalidArgumentError(
                f"space {self.space_name!r} holds {self.space.data_kind}, "
                f"but index was created with {data_type}"
            )
        if self.space.dist_kind is not dist_type:
            raise InvalidArgumentError(
                f"space {self.space_name!r} uses {self.space.dist_kind.value} distances, "
                f"but index was created with {dist_type.value}"
            )
        self.mesh = mesh
        if mesh is not None and method not in ("hnsw", "seq_search", "brute_force"):
            raise InvalidArgumentError(
                f"method {method!r} has no distributed implementation; "
                "mesh= supports hnsw and seq_search/brute_force"
            )
        self.store = DataStore(data_type)
        self.method = None
        self.built = False
        self._index_params: Params | None = None
        self._query_params: Params | None = None
        self._thread_pool_size = 0
        #: pad query batches to power-of-two buckets (see knn_query_batch)
        self.query_batch_bucketing = True

    # ---------------- validation (reference: lib.zig:351-378) ----------------

    def _validate_create_inputs(self) -> None:
        s = self.space_name
        if s == "leven" and self.dist_type is not DistKind.INT:
            raise InvalidArgumentError("leven requires Int distance type")
        if (
            (s.startswith("l2") or s.startswith("cosine"))
            and "sparse" not in s
            and s != "l2sqr_sift"  # fixed 128-byte SIFT layout needs no dim
            and not self.space_params.has("dim")
        ):
            raise InvalidArgumentError(f"space {s!r} requires a 'dim' space parameter")
        if (
            self.data_type is DataKind.UINT8
            and self.dist_type is not DistKind.INT
            and not s.startswith("bit_")
        ):
            raise InvalidArgumentError("dense uint8 vectors require Int distance type")

    # ---------------- insertion (deferred; lib.zig:625-681) ----------------

    def add_dense_batch(
        self,
        vectors: Any,
        ids: Sequence[int] | None = None,
        labels: Sequence[int] | None = None,
    ) -> None:
        with tracing.span("index.add"):
            self._check_dim(np.asarray(vectors))
            self._drain()
            old = len(self.store)
            self.store.add_dense_batch(vectors, ids, labels)
            self._mark_dirty(old)

    def add_uint8_batch(self, vectors: Any, ids: Sequence[int] | None = None) -> None:
        with tracing.span("index.add"):
            self._drain()
            old = len(self.store)
            self.store.add_uint8_batch(vectors, ids)
            self._mark_dirty(old)

    def add_sparse_batch(self, points, ids: Sequence[int] | None = None) -> None:
        """Sparse points as (ids, values) pairs or SparsePoint: ids 1-based
        and strictly increasing; object ids default to 1-based positions."""
        with tracing.span("index.add"):
            self._drain()
            old = len(self.store)
            self.store.add_sparse_batch(points, ids)
            self._mark_dirty(old)

    def add_bit_batch_packed(
        self,
        words: Any,
        n_bits: int | None = None,
        ids: Sequence[int] | None = None,
    ) -> None:
        """Add u32-word-packed bit vectors (the reference's native bit
        format, space_bit_hamming.h:43-52): bit j of word i is element
        32*i+j; pass ``n_bits`` to drop last-word padding. Unpacked to 0/1
        uint8 rows at ingestion (spaces/bits.py)."""
        from .spaces.bits import unpack_bit_vectors

        self.add_uint8_batch(unpack_bit_vectors(words, n_bits), ids)

    def add_string_batch(self, strings: Sequence[str | bytes], ids: Sequence[int] | None = None) -> None:
        with tracing.span("index.add"):
            self._drain()
            old = len(self.store)
            self.store.add_string_batch(strings, ids)
            self._mark_dirty(old)

    def delete_batch(self, positions: Sequence[int], strategy: str = "none") -> None:
        """Incremental deletion by store position; supported only by
        methods with incremental maintenance (reference: only sw-graph,
        small_world_rand.cc DeleteBatch)."""
        self._ensure_built()
        self._drain()
        self.method.delete_batch(positions, strategy)

    def _check_dim(self, arr: np.ndarray) -> None:
        want = self.space_params.get("dim")
        if want is not None and arr.ndim >= 1:
            d = arr.shape[-1]
            if int(want) != d:
                raise InvalidArgumentError(f"dim param is {want} but batch has dim {d}")

    def _mark_dirty(self, old_count: int) -> None:
        # A method with incremental maintenance (sw-graph) absorbs rows added
        # after the build in place (reference: AddBatch,
        # small_world_rand.cc:141); for every other method added data
        # invalidates the index and the next query rebuilds it (the reference
        # forbids mutation after the build instead, index.h:35).
        if self.built and self.method is not None and self.method.supports_incremental:
            self.method.add_batch(self.store, range(old_count, len(self.store)))
            return
        self.built = False

    # ---------------- the drain rule ----------------

    def _drain(self) -> None:
        """Wait for the batches knn_query_batch_async left in flight and
        re-raise their first error, so that every other call sees results,
        counters and the index as if the calls had run in order."""
        if self.method is not None:
            self.method.drain()

    # ---------------- build ----------------

    def _resolve_mesh(self):
        """int -> Mesh of this index's device type at first use."""
        if isinstance(self.mesh, int):
            from .parallel.mesh import make_mesh

            self.mesh = make_mesh(self.mesh, device=self.device)
        return self.mesh

    def _make_method(self, params: Params):
        """Method factory honoring the mesh routing (also used by the load
        path, io/persist.py)."""
        if self.mesh is not None:
            mesh = self._resolve_mesh()
            if self.method_name in ("seq_search", "brute_force"):
                from .parallel.sharded import DistributedSeqSearch

                return DistributedSeqSearch(self.space, mesh, params)
            from .parallel.hnsw_sharded import ShardedHnsw

            return ShardedHnsw(self.space, mesh, params)
        return create_method(self.method_name, self.space, params)

    def build_index(self, index_params: Params | dict | None = None, print_progress: bool = False) -> None:
        with tracing.span("index.build"):
            self._drain()
            params = Params.of(index_params) if index_params is not None else (self._index_params or Params())
            self._index_params = params
            if print_progress:
                log("INFO", f"building {self.method_name} over {len(self.store)} objects on {self.device}")
            self.method = self._make_method(params)
            self.method.progress = print_progress  # per-wave logging (hnsw)
            self.method.create_index(self.store, params)
            if self._query_params is not None:
                self.method.set_query_time_params(self._query_params)
            self.built = True

    def _ensure_built(self) -> None:
        """Auto-build on first use (reference: lib.zig:800 et al.)."""
        if not self.built:
            self.build_index(self._index_params)

    def clear_index_cache(self) -> None:
        """Drop the built index, keep the data (reference: lib.zig clearIndexCache)."""
        self._drain()
        self.method = None
        self.built = False

    def reset(self) -> None:
        """Drop index AND data (reference: lib.zig Index.reset)."""
        self.clear_index_cache()
        self.store = DataStore(self.data_type)

    # ---------------- queries ----------------

    def knn_query(self, point: Any, k: int) -> QueryResult:
        if k <= 0:
            raise InvalidArgumentError("k must be positive")
        batch = [point] if self.data_type is not DataKind.DENSE else np.asarray(point)[None, :]
        d, i = self.knn_query_batch(batch, k)
        return self._trim(d[0], i[0])

    def knn_query_batch(self, points: Any, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN: returns (dists[B,k], ids[B,k]); missing slots are
        (+inf, -1).

        Batch sizes are bucketed to the next power of two (minimum 8),
        padding with copies of the first query and slicing the results
        back, as tpu_knn does. Set ``index.query_batch_bucketing = False``
        to disable. Distance-computation counters reflect the padded
        (performed) work.
        """
        if k <= 0:
            raise InvalidArgumentError("k must be positive")
        with tracing.batch("api.knn") as sp:
            self._ensure_built()
            self._drain()
            pts, b = self._bucket_query_points(points)
            out = self._finish_knn(*self.method.knn(pts, k), b)
            tracing.resolve(sp.batch)  # the answers are on the host
            return out

    def _finish_knn(self, d, i, b: int):
        """Slice a bucketed batch back to ``b`` queries; rint INT distances."""
        d, i = d[:b], i[:b]
        if self.dist_type is DistKind.INT:
            d = np.where(np.isfinite(d), np.rint(d), d)
        return d, i

    def _bucket_query_points(self, points):
        """Prep + pad a query batch to its power-of-two bucket (copies
        of the first query; results are sliced back to the true batch).
        Returns (padded_points, true_batch_size)."""
        pts = self._prep_query_points(points)
        b = len(pts)
        bb = b
        if self.query_batch_bucketing and b > 0:
            bb = max(8, 1 << (b - 1).bit_length())
        if bb != b:
            if isinstance(pts, np.ndarray):
                pts = np.concatenate([pts, np.repeat(pts[:1], bb - b, axis=0)], 0)
            else:  # a list of sparse or string points
                pts = list(pts) + [pts[0]] * (bb - b)
        return pts, b

    def knn_query_batch_results(self, points: Any, k: int) -> list[QueryResult]:
        d, i = self.knn_query_batch(points, k)
        return [self._trim(dr, ir) for dr, ir in zip(d, i)]

    def knn_query_batch_async(self, points: Any, k: int) -> KnnFuture:
        """Dispatch a kNN batch and return a :class:`KnnFuture` at once;
        its ``.result()`` is what knn_query_batch returns.

        For seq_search/brute_force, hnsw, sw-graph and napp, this call
        validates (k, the build, the query points), encodes the queries
        and captures every query-time parameter, then queues the search
        on the in-order worker of the index's device (methods/base.py:
        one thread per device, on the card with a stream of its own, that
        serializes the batches of every index) and returns before the
        batch has run. Any other call on the index (kNN, range, add,
        build, delete, set_query_time_params, save, memory_usage_bytes,
        reading ``method.dist_comps``) first waits for its batches in
        flight; an error raised by a batch comes from its future's
        ``result()`` and from that next call. The other methods (vptree,
        simple_invindx, dummy, mesh=) run the batch inside this call."""
        if k <= 0:
            raise InvalidArgumentError("k must be positive")
        with tracing.batch("api.knn_async") as sp:
            self._ensure_built()
            pts, b = self._bucket_query_points(points)
            done = self.method.knn_async(pts, k)
        return KnnFuture(lambda: self._finish_knn(*done(), b), sp.batch)

    def range_query(self, point: Any, radius: float) -> QueryResult:
        batch = [point] if self.data_type is not DataKind.DENSE else np.asarray(point)[None, :]
        return self.range_query_batch(batch, radius)[0]

    def range_query_batch(self, points: Any, radius: float) -> list[QueryResult]:
        """Batched range search: one QueryResult per query, the ids and
        distances of every corpus point within ``radius``, ascending.
        Results stream through the device in chunks, never as [Q, N]."""
        with tracing.batch("api.range") as sp:
            self._ensure_built()
            self._drain()
            res = self.method.range(self._prep_query_points(points), radius)
            tracing.resolve(sp.batch)  # the answers are on the host
            if self.dist_type is DistKind.INT:
                return [QueryResult(ids, np.rint(dists)) for ids, dists in res]
            return [QueryResult(ids, dists) for ids, dists in res]

    def _prep_query_points(self, points: Any):
        if self.data_type is DataKind.SPARSE:
            return [p if isinstance(p, SparsePoint) else DataStore.validate_sparse(p) for p in points]
        if self.data_type is DataKind.STRING:
            return list(points)
        if self.data_type is DataKind.UINT8:
            arr = np.asarray(points, dtype=np.uint8)
            return arr[None, :] if arr.ndim == 1 else arr
        arr = np.asarray(points, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        self._check_dim(arr)
        return arr

    @staticmethod
    def _trim(dists: np.ndarray, ids: np.ndarray) -> QueryResult:
        keep = ids >= 0
        return QueryResult(ids[keep], dists[keep])

    # ---------------- params / metadata ----------------

    def set_query_time_params(self, params: Params | dict | None) -> None:
        self._ensure_built()
        self._drain()
        self._query_params = Params.of(params) if params is not None else None
        self.method.set_query_time_params(self._query_params)

    def set_thread_pool_size(self, n: int) -> None:
        if n < 0:
            raise InvalidArgumentError("thread pool size must be >= 0")
        self._thread_pool_size = n

    def get_thread_pool_size(self) -> int:
        return self._thread_pool_size

    def data_qty(self) -> int:
        return len(self.store)

    def get_space_type(self) -> str:
        # Reverse alias (reference: lib.zig:1234-1239).
        return self._requested_space if self._requested_space == "cosine" else self.space_name

    def get_method(self) -> str:
        return self.method_name

    def get_data_type(self) -> DataKind:
        return self.data_type

    def get_dist_type(self) -> DistKind:
        return self.dist_type

    # ---------------- data access ----------------

    def get_distance(self, pos_a: int, pos_b: int):
        """Space distance between two stored points (reference:
        nmslib_get_distance)."""
        return self.space.pairwise(self.store.get_point(pos_a), self.store.get_point(pos_b))

    def get_data_point(self, position: int):
        return self.store.get_point(position)

    def borrow_data_dense(self, position: int) -> np.ndarray:
        return np.asarray(self.store.get_point(position))

    def borrow_data_sparse(self, position: int) -> SparsePoint:
        return self.store.get_point(position)

    def borrow_data_point_string(self, position: int) -> str:
        return self.store.get_point(position).decode("utf-8")

    # ---------------- persistence ----------------

    def save(self, path: str, save_data: bool = True) -> None:
        """Write ``path``.idx.npz (and ``path``.dat.npz with ``save_data``)
        in tpu_knn's format v3."""
        self._ensure_built()
        self._drain()
        from .io.persist import save_index

        save_index(self, path, save_data)

    @classmethod
    def load(cls, path: str, load_data: bool = True, device: str | torch.device = "cuda") -> "Index":
        """Load a format-v3 index written by either package onto ``device``."""
        from .io.persist import load_index

        return load_index(path, load_data, device)

    def memory_usage_bytes(self) -> int:
        """Bytes of the index's tensors on its device (reference:
        nmslib_index_memory_usage, nmslib_c.cpp:1546-1565)."""
        self._drain()
        if self.method is None or self.method.data is None:
            return 0
        tensors = list(self.method.data.tensors()) + list(self.method.aux_device_arrays())
        return sum(t.nbytes for t in tensors)
