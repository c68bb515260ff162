"""Typed dataset containers and the deferred-insertion data store.

The reference keeps user data in a Zig-side arena until ``buildIndex``
pushes it down to C++ (``DataStorage``, reference: lib.zig:169-189,
625-681). We mirror that: ``DataStore`` accumulates host (numpy) batches
per data kind; at build time a method asks the space to *encode* the
store into padded tensors on the index's device.

Dense layout: f32[N_pad, D_pad] (+ ids i32[N_pad]). The true object count
is kept in ``count`` and padding rows are masked out of every query.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from .errors import InvalidArgumentError, InvalidSparseElementError


class DataKind(enum.Enum):
    """Mirrors nmslib_data_type_t (reference: nmslib_c.h:12-17)."""

    DENSE = "dense_vector"
    SPARSE = "sparse_vector"
    UINT8 = "dense_uint8_vector"
    STRING = "object_as_string"


class DistKind(enum.Enum):
    """Mirrors nmslib_dist_type_t (reference: nmslib_c.h:20)."""

    FLOAT = "float"
    INT = "int"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class SparsePoint:
    """One sparse vector: ids strictly increasing, >= 1 (1-based contract,
    reference: lib.zig:728-738, README.md:57)."""

    ids: np.ndarray  # int32[nnz]
    values: np.ndarray  # float32[nnz]


class DataStore:
    """Deferred-insertion arena. add_*_batch only copies host-side; device
    materialization happens at index build (reference: lib.zig:625-681)."""

    def __init__(self, kind: DataKind):
        self.kind = kind
        self.ids: list[int] = []
        self.labels: list[int] = []
        self._dense: list[np.ndarray] = []  # each [d] float32 or uint8
        self._sparse: list[SparsePoint] = []
        self._strings: list[bytes] = []
        self._dim: int | None = None

    # ---------------- insertion ----------------

    def add_dense_batch(
        self,
        vectors: Any,
        ids: Sequence[int] | None = None,
        labels: Sequence[int] | None = None,
    ) -> None:
        if self.kind is not DataKind.DENSE:
            raise InvalidArgumentError(f"store holds {self.kind}, not dense")
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise InvalidArgumentError("dense batch must be [batch, dim]")
        self._check_dim(arr.shape[1])
        start = len(self._dense)
        self._dense.extend(list(arr))
        self._assign_ids(arr.shape[0], start, ids, one_based=False, labels=labels)

    def add_uint8_batch(self, vectors: Any, ids: Sequence[int] | None = None) -> None:
        if self.kind is not DataKind.UINT8:
            raise InvalidArgumentError(f"store holds {self.kind}, not uint8")
        arr = np.asarray(vectors, dtype=np.uint8)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise InvalidArgumentError("uint8 batch must be [batch, dim]")
        self._check_dim(arr.shape[1])
        start = len(self._dense)
        self._dense.extend(list(arr))
        self._assign_ids(arr.shape[0], start, ids, one_based=False)

    def add_sparse_batch(
        self,
        points: Sequence[tuple[Sequence[int], Sequence[float]] | SparsePoint],
        ids: Sequence[int] | None = None,
    ) -> None:
        if self.kind is not DataKind.SPARSE:
            raise InvalidArgumentError(f"store holds {self.kind}, not sparse")
        start = len(self._sparse)
        parsed = [self.validate_sparse(p) for p in points]
        self._sparse.extend(parsed)
        # Sparse object ids default to 1-based positions (reference: lib.zig:748).
        self._assign_ids(len(parsed), start, ids, one_based=True)

    def add_string_batch(self, strings: Sequence[str | bytes], ids: Sequence[int] | None = None) -> None:
        if self.kind is not DataKind.STRING:
            raise InvalidArgumentError(f"store holds {self.kind}, not string")
        start = len(self._strings)
        for s in strings:
            self._strings.append(s.encode("utf-8") if isinstance(s, str) else bytes(s))
        self._assign_ids(len(strings), start, ids, one_based=False)

    @staticmethod
    def validate_sparse(point: tuple[Sequence[int], Sequence[float]] | SparsePoint) -> SparsePoint:
        """Enforce the 1-based strictly-increasing element-id contract
        (reference: lib.zig:728-738)."""
        if isinstance(point, SparsePoint):
            sids, vals = np.asarray(point.ids), np.asarray(point.values)
        else:
            sids, vals = np.asarray(point[0]), np.asarray(point[1])
        sids = sids.astype(np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        if sids.shape != vals.shape or sids.ndim != 1:
            raise InvalidSparseElementError("sparse ids/values must be equal-length 1-D")
        if sids.size:
            if sids[0] < 1:
                raise InvalidSparseElementError("sparse element ids must be >= 1")
            if np.any(np.diff(sids) <= 0):
                raise InvalidSparseElementError("sparse element ids must be strictly increasing")
        return SparsePoint(sids.astype(np.int32), vals)

    # ---------------- accessors ----------------

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def dim(self) -> int | None:
        return self._dim

    def dense_matrix(self) -> np.ndarray:
        if not self._dense:
            d = self._dim or 0
            dt = np.uint8 if self.kind is DataKind.UINT8 else np.float32
            return np.zeros((0, d), dtype=dt)
        return np.stack(self._dense)

    def sparse_points(self) -> list[SparsePoint]:
        return self._sparse

    def strings(self) -> list[bytes]:
        return self._strings

    def get_point(self, position: int):
        """Raw data-point retrieval (reference: lib.zig getDataPoint /
        borrowData*, nmslib_c.cpp:1155-1330)."""
        if position < 0 or position >= len(self.ids):
            raise InvalidArgumentError(f"position {position} out of range")
        if self.kind in (DataKind.DENSE, DataKind.UINT8):
            return self._dense[position]
        if self.kind is DataKind.SPARSE:
            return self._sparse[position]
        return self._strings[position]

    # ---------------- internals ----------------

    def _check_dim(self, d: int) -> None:
        if self._dim is None:
            self._dim = d
        elif self._dim != d:
            raise InvalidArgumentError(f"dim mismatch: store has {self._dim}, batch has {d}")

    def _assign_ids(
        self,
        n: int,
        start: int,
        ids: Sequence[int] | None,
        one_based: bool,
        labels: Sequence[int] | None = None,
    ) -> None:
        if ids is not None:
            if len(ids) != n:
                raise InvalidArgumentError("ids length must match batch size")
            self.ids.extend(int(i) for i in ids)
        else:
            base = 1 if one_based else 0
            self.ids.extend(range(start + base, start + base + n))
        if labels is not None:
            if len(labels) != n:
                raise InvalidArgumentError("labels length must match batch size")
            self.labels.extend(int(x) for x in labels)
        else:
            self.labels.extend([-1] * n)

    def label_of_id(self) -> dict[int, int]:
        """object id -> label map (Object::label analog, object.h)."""
        return dict(zip(self.ids, self.labels))


# ---------------- device-side encoded forms ----------------


@dataclass
class DenseDeviceData:
    """Encoded dense corpus: padded to [N_pad, D_pad]; rows beyond ``count``
    are padding. ``row_term`` holds per-row precomputed scalars used by
    matmul-factored distances (squared norms for l2; reference analog:
    space_l2sqr_sift.cc:136-150). All tensors live on one device."""

    vecs: torch.Tensor  # f32[N_pad, D_pad] (space-transformed columns), int8 for l2sqr_sift
    ids: torch.Tensor  # i32[N_pad], -1 on padding rows
    count: int
    dim: int  # true (unpadded) dim
    row_term: torch.Tensor | None = None  # f32[N_pad] or None
    extra: dict = field(default_factory=dict)  # "pad": f32[N_pad], PAD_TERM on padding

    def tensors(self):
        """Every tensor the corpus holds (for memory accounting)."""
        out = [self.vecs, self.ids, self.row_term, *self.extra.values()]
        return [t for t in out if isinstance(t, torch.Tensor)]


def dense_data_from_numpy(vecs, ids, count: int, dim: int, row_term, pad, device,
                          extra: dict | None = None) -> DenseDeviceData:
    """Build a :class:`DenseDeviceData` on ``device`` from host arrays, e.g.
    the fields of a tpu_knn ``DenseDeviceData`` converted with np.asarray,
    so a corpus one package encoded can be scanned by the other. An int8
    ``vecs`` (l2sqr_sift) stays int8, any other becomes f32. The 0-d
    entries of ``extra`` (the certificate metadata: max_sq_norm,
    max_lo_norm, max_blo_err) are carried across as 0-d f32 tensors."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)  # a copy

    vecs = np.asarray(vecs)
    data = DenseDeviceData(
        vecs=t(vecs, torch.int8 if vecs.dtype == np.int8 else torch.float32),
        ids=t(ids, torch.int32),
        count=int(count),
        dim=int(dim),
        row_term=None if row_term is None else t(row_term, torch.float32),
    )
    data.extra["pad"] = t(pad, torch.float32)
    for key, v in (extra or {}).items():
        if np.ndim(v) == 0:
            data.extra[key] = t(v, torch.float32)
    return data
