"""sparse_dense_fusion space (counterpart of tpu_knn/spaces/fusion.py;
reference: include/space/space_sparse_dense_fusion.h,
src/space/space_sparse_dense_fusion.cc).

Distance = -sum_c weight_c * dot_c over the object's components, each a
dense vector (ScalarProductSIMD) or a sparse vector
(SparseScalarProductFast); the weight set differs between index time and
query time (compDistance(isQueryTime)). Objects are JSON strings

    {"dense": [[...f32...], ...], "sparse": [[[ids...],[vals...]], ...]}

added through add_string_batch; weights come from the reference's
weight-file format (``weightfile``) or from ``indexWeights`` /
``queryWeights`` comma-separated parameters. Dense components go through
ops/distance at ``precision`` (IEEE f32), sparse ones through the
binary-search lookup of ops/sparse (tpu_knn's ``dot_blocked``). Besides
``block`` the space scores the graph's gathered candidates and the
construction heuristic's pairs (``gathered_block``, ``pair_block``), where
tpu_knn vmaps ``block``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore, DistKind, StringDeviceData, round_up
from ..core.errors import DataIOError, InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_space
from ..ops import distance as D
from ..ops import sparse as S
from .base import Space
from .dense import PAD_TERM
from .sparse import _pack_csr


def _parse_weights(v) -> list[float]:
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    return [float(x) for x in str(v).split(",") if x.strip()]


def _read_weight_file(path: str) -> tuple[list[float], list[float]]:
    qw = iw = None
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line.startswith("queryWeights:"):
                    qw = _parse_weights(line[len("queryWeights:"):])
                elif line.startswith("indexWeights:"):
                    iw = _parse_weights(line[len("indexWeights:"):])
    except OSError as e:
        raise DataIOError(f"Cannot open file: '{path}' for reading: {e}")
    if not qw or not iw or len(qw) != len(iw):
        raise InvalidArgumentError(
            "Zero or non-matching # of weights in the file "
            f"'{path}' # of index weights: {0 if not iw else len(iw)} "
            f"# of query weights: {0 if not qw else len(qw)}"
        )
    return iw, qw


@register_space("sparse_dense_fusion")
class SparseDenseFusionSpace(Space):
    name = "sparse_dense_fusion"
    data_kind = DataKind.STRING
    dist_kind = DistKind.FLOAT
    preferred_chunk = 512

    def __init__(self, params: Params | None = None, device="cpu"):
        super().__init__(params, device)
        pm = ParamManager(self.params)
        wfile = pm.get("weightfile", None, str)
        iw = pm.get("indexWeights", None)
        qw = pm.get("queryWeights", None)
        pm.check_unused()
        if wfile:
            self.index_weights, self.query_weights = _read_weight_file(wfile)
        else:
            self.index_weights = _parse_weights(iw) if iw is not None else None
            self.query_weights = _parse_weights(qw) if qw is not None else None
        if (self.index_weights is None) != (self.query_weights is None):
            raise InvalidArgumentError("sparse_dense_fusion needs both indexWeights and queryWeights")
        # the component layout travels with the encoded dicts' keys, and the
        # two weight sets are fixed here: no per-encode state on the space
        self._index_view: SparseDenseFusionSpace | None = None

    def construction_space(self):
        """A view that scores with indexWeights, for index-time distances
        (graph construction), as the reference's compDistance(isQueryTime=
        false); queries keep this instance (queryWeights)."""
        if self.index_weights == self.query_weights or self.index_weights is None:
            return self
        if self._index_view is None:
            view = object.__new__(SparseDenseFusionSpace)
            view.__dict__.update(self.__dict__)
            view.query_weights = self.index_weights  # the scorers read these
            view._index_view = view
            self._index_view = view
        return self._index_view

    # -- component parsing --
    @staticmethod
    def _parse(points) -> list[dict]:
        out = []
        for p in points:
            s = p.decode("utf-8") if isinstance(p, bytes) else str(p)
            try:
                obj = json.loads(s)
            except json.JSONDecodeError as e:
                raise InvalidArgumentError(f"bad fusion object JSON: {e}")
            out.append({
                "dense": [np.asarray(v, np.float32) for v in obj.get("dense", [])],
                "sparse": [DataStore.validate_sparse((np.asarray(i), np.asarray(v)))
                           for i, v in obj.get("sparse", [])],
            })
        return out

    def _n_comp(self, parsed) -> int:
        if not parsed:
            return 0
        n = len(parsed[0]["dense"]) + len(parsed[0]["sparse"])
        for p in parsed:
            if len(p["dense"]) + len(p["sparse"]) != n:
                raise InvalidArgumentError("fusion objects have differing component counts")
        return n

    def _check_weights(self, n: int) -> None:
        """Too FEW weights for the components is an error, extras are ignored
        (space_sparse_dense_fusion.cc indexes only i < weights.size());
        n == 0 (an empty batch) checks nothing."""
        if n == 0:
            return
        for label, w in (("index", self.index_weights), ("query", self.query_weights)):
            if w is not None and len(w) < n:
                raise InvalidArgumentError(f"Too few {label} weights: {len(w)} < {n} components")

    def _encode_components(self, parsed, n_pad: int, query: bool) -> dict:
        """{key: tensor}: dense components as matrices 'd{c}', sparse ones as
        padded CSR 'sc{c}' / 'sv{c}'."""
        arrays = {}
        if not parsed:
            return arrays
        for c in range(len(parsed[0]["dense"])):
            mat = np.stack([p["dense"][c] for p in parsed]).astype(np.float32)
            dpad = np.zeros((n_pad, round_up(mat.shape[1], 8)), np.float32)
            dpad[: mat.shape[0], : mat.shape[1]] = mat
            arrays[f"d{c}"] = dpad
        pad_col = S.PAD_Q if query else S.PAD_X
        for c in range(len(parsed[0]["sparse"])):
            col, val, _ = _pack_csr([p["sparse"][c] for p in parsed], n_pad, pad_col=pad_col)
            arrays[f"sc{c}"] = col
            arrays[f"sv{c}"] = val
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    # -- Space interface --
    def encode_dataset(self, store: DataStore, row_multiple: int = 8) -> StringDeviceData:
        parsed = self._parse(store.strings())
        n = len(parsed)
        n_pad = round_up(max(n, 1), row_multiple)
        arrays = self._encode_components(parsed, n_pad, query=False)
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = np.full(n_pad, -1, np.int32)
        ids[:n] = np.asarray(store.ids, np.int32)
        dev = self.device
        data = StringDeviceData(
            chars=torch.zeros((n_pad, 1), dtype=torch.int32, device=dev),  # unused: fusion keeps components
            length=torch.zeros(n_pad, dtype=torch.int32, device=dev),
            ids=torch.from_numpy(ids).to(dev),
            count=n,
        )
        data.extra["pad"] = torch.from_numpy(pad).to(dev)
        data.extra.update(arrays)
        # _n_comp rejects mixed schemas (reference CHECK_MSG(start1 == datalength))
        self._check_weights(self._n_comp(parsed))
        return data

    def encode_queries(self, points) -> dict:
        parsed = self._parse(points)
        enc = {f"q_{k}": v for k, v in self._encode_components(parsed, len(parsed), query=True).items()}
        self._check_weights(self._n_comp(parsed))
        return enc

    @staticmethod
    def _layout_of(keys) -> list[tuple]:
        """Component layout from an encoded dict's OWN keys ('d{c}' dense,
        'sc{c}'/'sv{c}' sparse, with or without the query 'q_' prefix)."""
        names = {k.removeprefix("q_") for k in keys}
        layout: list[tuple] = []
        c = 0
        while f"d{c}" in names:  # dense components first (encode order)
            layout.append(("dense", f"d{c}"))
            c += 1
        c = 0
        while f"sc{c}" in names:
            layout.append(("sparse", f"sc{c}", f"sv{c}"))
            c += 1
        return layout

    def slice_data(self, data, start: int, size: int) -> dict:
        sl = slice(start, start + size)
        return {k: v[sl] for k, v in data.extra.items()}

    def corpus_dict(self, data) -> dict:
        layout = self._layout_of(data.extra.keys())
        c = {"vecs": data.extra[layout[0][1]] if layout else data.extra["pad"], "pad": data.extra["pad"],
             "count": data.count}
        for k, v in data.extra.items():
            if k != "pad":
                c[k] = v  # with the row_mask when deletions installed one
        return c

    def _combine(self, qenc, dense, sparse, shape) -> torch.Tensor:
        """-sum_c w_c * dot_c over the components; ``dense(key)`` and
        ``sparse(ckey, vkey)`` give one component's dots. A weight <= FLT_MIN
        drops its component (reference space_sparse_dense_fusion.cc:297)."""
        layout = self._layout_of(k for k in qenc if k.startswith("q_"))
        weights = self.query_weights or [1.0] * len(layout)
        res = None
        for comp, w in zip(layout, weights):
            if w <= np.finfo(np.float32).tiny:
                continue
            val = dense(comp[1]) if comp[0] == "dense" else sparse(comp[1], comp[2])
            res = val * w if res is None else res + val * w
        if res is None:
            res = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return -res

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        nq = next((v.shape[0] for k, v in qenc.items() if k.startswith("q_")), 0)
        res = self._combine(
            qenc,
            lambda k: D.matmul(qenc[f"q_{k}"], xc[k], precision),
            lambda ck, vk: S.lookup_dot_blocked(qenc[f"q_{ck}"], qenc[f"q_{vk}"], xc[ck], xc[vk]),
            (nq, xc["pad"].shape[0]),
        )
        return res + xc["pad"][None, :]

    def gathered_block(self, qenc, rows, pad, extra) -> torch.Tensor:
        """Distances f32[B, K] of query b to its own gathered objects (each
        component's rows in ``extra``: 'd{c}' [B, K, D], 'sc{c}'/'sv{c}'
        [B, K, nnz])."""

        def sparse(ck, vk):
            vals, _ = S.lookup_query_vals(qenc[f"q_{ck}"], qenc[f"q_{vk}"], extra[ck])
            return torch.sum(vals * extra[vk], dim=-1)

        return self._combine(qenc, lambda k: D.batched_dot(qenc[f"q_{k}"], extra[k]), sparse, pad.shape) + pad

    def pair_block(self, qe, rows, pad, extra, v_pad=None) -> torch.Tensor:
        """Distances [B, C, C2] of per-row candidate sets (the construction
        heuristic): a-side encodings [B, C, ...] against gathered objects
        [B, C2, ...]."""
        c = next((v.shape[1] for k, v in qe.items() if k.startswith("q_")), 0)
        return self._combine(
            qe,
            lambda k: D.pair_dot(qe[f"q_{k}"], extra[k]),
            lambda ck, vk: S.pair_dots(qe[f"q_{ck}"], qe[f"q_{vk}"], extra[ck], extra[vk]),
            (pad.shape[0], c, pad.shape[1]),
        ) + pad[:, None, :]
