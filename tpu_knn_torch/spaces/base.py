"""Space abstraction (counterpart of tpu_knn/spaces/base.py; reference:
include/space.h:130-276).

A Space owns:

  * ``encode_dataset``  — DataStore -> padded tensors on ``self.device``,
    applying the space's element transform once (the analog of
    precomputed-norm object layouts, space_l2sqr_sift.cc:136-150).
  * ``encode_queries``  — raw query points -> transformed tensors.
  * ``block``           — the blocked distance: (encoded queries, slice of
    encoded corpus) -> [Q, C] distances. Every index method is built on it.
  * ``slice_data``      — corpus chunk extraction for streaming scans.
  * ``pairwise``        — one-pair distance for getDistance
    (reference: nmslib_c.cpp nmslib_get_distance).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore, DistKind
from ..core.params import Params


class Space:
    name: str = "abstract"
    dist_kind: DistKind = DistKind.FLOAT
    data_kind: DataKind = DataKind.DENSE

    def __init__(self, params: Params | None = None, device: str | torch.device = "cpu"):
        self.params = Params.of(params)
        self.device = torch.device(device)

    # -- corpus --
    def encode_dataset(self, store: DataStore):
        raise NotImplementedError

    def slice_data(self, data, start: int, size: int):
        """Return the chunk [start:start+size) of encoded corpus rows as the
        structure ``block`` expects for its second argument."""
        raise NotImplementedError

    # -- queries --
    def encode_queries(self, points: Any):
        """points: host-side raw query batch in the store's native format."""
        raise NotImplementedError

    # -- distances --
    def block(self, qenc, xchunk, precision: str = "float32"):
        raise NotImplementedError

    def pass1_affine(self):
        """If the distance is affine-monotone in the factored matmul —
        order(dist) == order(scale*<q,x> + sq*q_term + sx*x_term) — return
        (scale, sq, sx) so the fused group-min kernel (ops/groupmin.py) can
        run pass 1 of the exact two-pass scan and gather-based scoring can
        use one batched matmul (ops/graph.py score_gathered). Monotone
        post-transforms (sqrt) are dropped for candidate *selection*;
        :meth:`pass1_post` maps the affine surrogate back to the true
        distance. Return None when the distance doesn't factor this way."""
        return None

    def pass1_elementwise(self):
        """If the distance is an elementwise form of ops/elementwise.py
        (reduce over D of f(q[d], x[d]), then a post), return (form, p) so
        the exact scan runs its kernel: pass 1's group mins in one launch,
        the single-pass and range scans' distances one launch a chunk. p is
        the exponent of form "lp", else None. Return None for any other
        distance."""
        return None

    def pass1_post(self, s, qenc):
        """Map the affine surrogate of :meth:`pass1_affine` to the true
        distance (e.g. sqrt for l2). Must be exact, not just monotone."""
        return s

    def term_from_rows(self, rows):
        """Recompute the per-row term from (gathered, transformed) corpus
        rows, when possible: cheaper than gathering a separate term array.
        Return None when the term isn't a function of the stored row."""
        return None

    # -- gather support (ops/graph.py) --
    def corpus_dict(self, data) -> dict:
        """Row-indexed corpus tensors for gather-based scoring.

        'vecs' is gathered into block()'s ``x`` slot. Padding rows are
        detected as positions >= 'count'; a method that masks real rows
        (sw-graph deletions) installs a 'row_mask' in data.extra, which is
        gathered instead. The per-row term is included only when
        :meth:`term_from_rows` can't recompute it.
        """
        c = {"vecs": data.vecs, "count": data.count}
        if "row_mask" in data.extra:
            c["row_mask"] = data.extra["row_mask"]
        if getattr(data, "row_term", None) is not None and not self.term_recompute:
            c["term"] = data.row_term
        return c

    #: True when term_from_rows reconstructs the row term exactly.
    term_recompute: bool = False

    def rows_as_queries(self, rows):
        """Query encodings built directly from (already-encoded) corpus
        rows, for spaces whose corpus and query transforms coincide.
        Return None when the encodes differ."""
        return None

    def store_as_query_points(self, store: DataStore):
        """The store's raw points in encode_queries' input format."""
        if self.data_kind in (DataKind.DENSE, DataKind.UINT8):
            return store.dense_matrix()
        if self.data_kind is DataKind.SPARSE:
            return np.asarray(store.sparse_points(), dtype=object)
        return np.asarray(store.strings(), dtype=object)

    def pairwise(self, a, b) -> float:
        """One-pair distance on raw points."""
        qenc = self.encode_queries([a])
        data = self._encode_raw_points([b])
        d = self.block(qenc, self.slice_data(data, 0, 1))
        v = float(d[0, 0].item())
        return int(round(v)) if self.dist_kind is DistKind.INT else v

    def _encode_raw_points(self, points):
        """Encode a small list of raw points as corpus data (for pairwise)."""
        store = DataStore(self.data_kind)
        if self.data_kind is DataKind.DENSE:
            store.add_dense_batch(np.asarray(points, dtype=np.float32))
        elif self.data_kind is DataKind.UINT8:
            store.add_uint8_batch(np.asarray(points, dtype=np.uint8))
        elif self.data_kind is DataKind.SPARSE:
            store.add_sparse_batch(points)
        else:
            store.add_string_batch(points)
        return self.encode_dataset(store)

    # -- misc --
    def approx_equal(self, a, b, tol: float = 1e-5) -> bool:
        """Reference: Space::ApproxEqual (space.h:203-207), testing aid."""
        return bool(abs(self.pairwise(a, b)) <= tol)

    def construction_space(self):
        """Space used for index-time distance computations (the
        reference's compDistance(isQueryTime=false) distinction)."""
        return self

    def __repr__(self):
        return f"<Space {self.name} on {self.device}>"
