"""SQFD, the signature quadratic form distance (counterpart of
tpu_knn/spaces/sqfd.py; reference: include/space/space_sqfd.h,
src/space/space_sqfd.cc, which the reference's own build excludes,
build.zig:16).

An object is a *signature*: a set of (weight, center in R^d) clusters.
With W = [w_a, -w_b] and A[i,j] = f(L2(c_i, c_j)) over the union of both
signatures' centers (space_sqfd.cc HiddenDistance):

    SQFD(a, b) = sqrt( W^T A W ) = sqrt( s_a + s_b - 2 * w_a^T F_ab w_b )

where s_x = w_x^T F_xx w_x is a per-object self term computed at encode
time and the cross term F_ab = f(L2(centers_a, centers_b)) comes from one
IEEE f32 product of all center pairs (tpu_knn's HIGHEST-precision dot).
Similarity functions (space_sqfd.h:49-99):

    sqfd_minus_func      f(d) = -d
    sqfd_heuristic_func  f(d) = 1 / (alpha + d)
    sqfd_gaussian_func   f(d) = exp(-alpha d^2)

Objects are JSON strings ``{"weights": [...], "centers": [[...], ...]}``
added through add_string_batch; padding clusters have weight 0. Besides
``block`` the space scores the graph's gathered candidates and the
construction heuristic's pairs (``gathered_block``, ``pair_block``) with
the same cross term, where tpu_knn vmaps ``block``; every block holds at
most ``ops/distance.block_elems`` elements of F.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore, DistKind, StringDeviceData, round_up
from ..core.errors import InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_space
from ..ops.distance import block_elems, require_ieee_f32
from .base import Space
from .dense import PAD_TERM


def _pair_l2(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """L2 distances between two center sets, batched: [..., A, d] x
    [..., B, d] -> [..., A, B], the product in IEEE f32."""
    require_ieee_f32(ca)
    g = ca @ cb.transpose(-1, -2)
    sa = torch.sum(ca * ca, dim=-1)
    sb = torch.sum(cb * cb, dim=-1)
    return torch.sqrt(torch.clamp_min(sa[..., :, None] + sb[..., None, :] - 2 * g, 0.0))


def _blocks(n: int, per_row: int, dev: torch.device):
    step = max(1, block_elems(dev) // max(per_row, 1))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


class SqfdSpaceBase(Space):
    data_kind = DataKind.STRING
    dist_kind = DistKind.FLOAT

    def __init__(self, params: Params | None = None, device="cpu"):
        super().__init__(params, device)
        pm = ParamManager(self.params)
        self.alpha = pm.get("alpha", 1.0, float)
        pm.check_unused()

    @property
    def preferred_chunk(self) -> int:
        """Corpus rows a scan step: tpu_knn's 128 on the CPU (its routes and
        tie orders), 2048 on a card; ``block`` splits a step to fit
        block_elems."""
        return 2048 if self.device.type == "cuda" else 128

    def _f(self, d):
        raise NotImplementedError

    # -- parsing --
    @staticmethod
    def _parse(points):
        sigs = []
        for p in points:
            s = p.decode("utf-8") if isinstance(p, bytes) else str(p)
            try:
                o = json.loads(s)
            except json.JSONDecodeError as e:
                raise InvalidArgumentError(f"bad SQFD signature JSON: {e}")
            w = np.asarray(o["weights"], np.float32)
            c = np.asarray(o["centers"], np.float32)
            if c.ndim != 2 or w.shape[0] != c.shape[0]:
                raise InvalidArgumentError("SQFD: weights/centers shape mismatch")
            sigs.append((w, c))
        return sigs

    def _pack(self, sigs, n_pad: int):
        cmax = round_up(max((w.shape[0] for w, _ in sigs), default=1), 8)
        d = sigs[0][1].shape[1] if sigs else 1
        dp = round_up(max(d, 1), 8)
        weights = np.zeros((n_pad, cmax), np.float32)
        centers = np.zeros((n_pad, cmax, dp), np.float32)
        for i, (w, c) in enumerate(sigs):
            if c.shape[1] != d:
                raise InvalidArgumentError("SQFD: differing feature dimensions")
            weights[i, : w.shape[0]] = w
            centers[i, : c.shape[0], :d] = c
        return torch.from_numpy(weights).to(self.device), torch.from_numpy(centers).to(self.device)

    def _self_terms(self, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """s_x = w^T f(L2(c, c)) w for every object, in row blocks."""
        out = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
        for s, e in _blocks(w.shape[0], w.shape[1] ** 2, w.device):
            f = self._f(_pair_l2(c[s:e], c[s:e]))
            out[s:e] = torch.einsum("ni,nij,nj->n", w[s:e], f, w[s:e])
        return out

    # -- Space interface --
    def encode_dataset(self, store: DataStore, row_multiple: int = 8) -> StringDeviceData:
        sigs = self._parse(store.strings())
        n = len(sigs)
        n_pad = round_up(max(n, 1), row_multiple)
        w, c = self._pack(sigs, n_pad)
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = np.full(n_pad, -1, np.int32)
        ids[:n] = np.asarray(store.ids, np.int32)
        dev = self.device
        data = StringDeviceData(
            chars=torch.zeros((n_pad, 1), dtype=torch.int32, device=dev),  # unused: SQFD keeps w, c
            length=torch.zeros(n_pad, dtype=torch.int32, device=dev),
            ids=torch.from_numpy(ids).to(dev),
            count=n,
        )
        data.extra["pad"] = torch.from_numpy(pad).to(dev)
        data.extra["w"] = w
        data.extra["c"] = c
        data.extra["self"] = self._self_terms(w, c)
        return data

    def encode_queries(self, points) -> dict:
        sigs = self._parse(points)
        w, c = self._pack(sigs, len(sigs))
        return {"qw": w, "qc": c, "q_self": self._self_terms(w, c)}

    def slice_data(self, data, start: int, size: int) -> dict:
        sl = slice(start, start + size)
        return {"x": data.extra["w"][sl], "c": data.extra["c"][sl], "self": data.extra["self"][sl],
                "pad": data.extra["pad"][sl]}

    def corpus_dict(self, data) -> dict:
        c = {"vecs": data.extra["w"], "c": data.extra["c"], "self": data.extra["self"],
             "pad": data.extra["pad"], "count": data.count}
        if "row_mask" in data.extra:
            c["row_mask"] = data.extra["row_mask"]
        return c

    def _dist(self, sq):
        return torch.sqrt(torch.clamp_min(sq, 0.0))

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        qw, qc = qenc["qw"], qenc["qc"]  # [Q, Cq], [Q, Cq, d]
        xw, xcen = xc["x"], xc["c"]  # [X, Cx], [X, Cx, d]
        q, cq, d = qc.shape
        x, cx, _ = xcen.shape
        cross = torch.empty((q, x), dtype=torch.float32, device=qw.device)
        for s, e in _blocks(x, q * cq * cx, qw.device):
            # the block's cross center distances as one [Q*Cq, X'*Cx] product
            dd = _pair_l2(qc.reshape(q * cq, d), xcen[s:e].reshape((e - s) * cx, d))
            f = self._f(dd).reshape(q, cq, e - s, cx)
            cross[:, s:e] = torch.einsum("qi,qixj,xj->qx", qw, f, xw[s:e])
        sq = qenc["q_self"][:, None] + xc["self"][None, :] - 2.0 * cross
        return self._dist(sq) + xc["pad"][None, :]

    def gathered_block(self, qenc, rows, pad, extra) -> torch.Tensor:
        """Distances f32[B, K] of query b to its own gathered signatures
        (weights ``rows`` [B, K, Cx], centers extra 'c' [B, K, Cx, d])."""
        qw, qc = qenc["qw"], qenc["qc"]
        b, k, cx = rows.shape
        cq, d = qc.shape[1], qc.shape[2]
        cross = torch.empty((b, k), dtype=torch.float32, device=rows.device)
        for s, e in _blocks(b, k * cq * cx, rows.device):
            dd = _pair_l2(qc[s:e], extra["c"][s:e].reshape(e - s, k * cx, d))  # [B', Cq, K*Cx]
            f = self._f(dd).reshape(e - s, cq, k, cx)
            cross[s:e] = torch.einsum("bi,bikj,bkj->bk", qw[s:e], f, rows[s:e])
        return self._dist(qenc["q_self"][:, None] + extra["self"] - 2.0 * cross) + pad

    def pair_block(self, qe, rows, pad, extra, v_pad=None) -> torch.Tensor:
        """Distances [B, C, C2] of per-row candidate sets (the construction
        heuristic): a-side encodings qw [B, C, Cq], qc [B, C, Cq, d] against
        gathered signatures [B, C2, Cx]."""
        qw, qc = qe["qw"], qe["qc"]
        b, c, cq, d = qc.shape
        c2, cx = rows.shape[1], rows.shape[2]
        cross = torch.empty((b, c, c2), dtype=torch.float32, device=rows.device)
        for s, e in _blocks(b, c * cq * c2 * cx, rows.device):
            dd = _pair_l2(qc[s:e].reshape(e - s, c * cq, d), extra["c"][s:e].reshape(e - s, c2 * cx, d))
            f = self._f(dd).reshape(e - s, c, cq, c2, cx)
            cross[s:e] = torch.einsum("bci,bcikj,bkj->bck", qw[s:e], f, rows[s:e])
        sq = qe["q_self"][:, :, None] + extra["self"][:, None, :] - 2.0 * cross
        return self._dist(sq) + pad[:, None, :]


@register_space("sqfd_minus_func")
class SqfdMinus(SqfdSpaceBase):
    name = "sqfd_minus_func"

    def _f(self, d):
        return -d


@register_space("sqfd_heuristic_func")
class SqfdHeuristic(SqfdSpaceBase):
    name = "sqfd_heuristic_func"

    def _f(self, d):
        return 1.0 / (self.alpha + d)


@register_space("sqfd_gaussian_func")
class SqfdGaussian(SqfdSpaceBase):
    name = "sqfd_gaussian_func"

    def _f(self, d):
        return torch.exp(-self.alpha * d * d)
