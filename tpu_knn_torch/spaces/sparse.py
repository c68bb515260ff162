"""Sparse vector spaces over padded CSR (counterpart of
tpu_knn/spaces/sparse.py).

The reference families, all registered under tpu_knn's names:
  * the sparse scalar-product spaces (include/space/space_sparse_scalar.h)
    ``cosinesimil_sparse``, ``angulardist_sparse``, ``negdotprod_sparse``,
    ``querynorm_negdotprod_sparse``, their ``_fast`` aliases
    (space_sparse_scalar_fast.h: a storage/SIMD format on the CPU, one
    formulation here) and the presence-only ``_bin_fast`` variants
    (space_sparse_bin_common.h, values forced to 1);
  * the union-of-supports Lp spaces ``l1_sparse``, ``l2_sparse``,
    ``linf_sparse``, ``lp_sparse`` (space_sparse_lp.h);
  * ``sparse_jaccard`` / ``jaccard_sparse`` (space_sparse_jaccard.h).

Element ids obey the API contract: >= 1, strictly increasing. The padded
layout and the primitives are in ops/sparse.py. Host packing goes through
the native runtime (io/native.py pack_csr) with its numpy fallback, so
encoded arrays are bit-equal to tpu_knn's.

A dot-family or jaccard corpus whose largest id is at most VOCAB_DENSE_MAX
carries ``vocab_mark``, an int8 tensor whose length is the padded
vocabulary: every scoring site sizes its densified query table from the
corpus it scores. Such spaces also build a JL-sketch proxy for graph
construction (:class:`SketchProxySpace`, methods/hnsw.py). The Lp spaces
look elements up by binary search and need no vocabulary bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dataset import (
    DataKind,
    DataStore,
    DenseDeviceData,
    DistKind,
    SparseDeviceData,
    SparsePoint,
    round_up,
)
from ..core.errors import InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_space
from ..ops import distance as D
from ..ops import sparse as S
from ..utils import tracing
from .base import Space
from .dense import PAD_TERM

#: Largest padded vocabulary of the densified query tables.
VOCAB_DENSE_MAX = 65536
#: Corpus rows a scan step scores on the card. The streaming top-k sorts
#: [Q, k + chunk] a step, and up to k = 16 that stays within torch's
#: in-block sort (rows of at most 4096): the 1M cell's 246 merges took 31.9
#: ms against 64.9 ms for 245 of [512, 4106], the segmented sort
#: (tools/sparse_scan_profile.py on an H100). Ties keep the lowest column
#: whatever the chunk (ops/topk.streaming_smallest_k).
CARD_CHUNK = 4080


def _pack_csr(points: list[SparsePoint], n_pad: int, nnz_mult: int = 8, pad_col: int = S.PAD_X):
    """Pack SparsePoints into padded CSR host arrays (native tk_pack_csr
    when the library builds, numpy otherwise)."""
    from ..io import native

    nnz_max = max((len(p.ids) for p in points), default=1)
    nnz_max = round_up(max(nnz_max, 1), nnz_mult)
    row_len = np.asarray([len(p.ids) for p in points], np.int32)
    ids = np.concatenate([p.ids for p in points]).astype(np.int32) if points else np.zeros(0, np.int32)
    vals = np.concatenate([p.values for p in points]).astype(np.float32) if points else np.zeros(0, np.float32)
    return native.pack_csr(row_len, ids, vals, n_pad, nnz_max, int(pad_col))


class SketchProxySpace:
    """Ordering-only dense stand-in for a sparse space over JL sketches.

    Graph methods only compare distances (beam merges, greedy descent, the
    neighbour-selection heuristic), so a score that keeps the host space's
    per-query order steers traversal and construction. The proxy scores
    d = -<s_q, s_x> on the random-projection sketches of
    ops/sparse.sketch_csr (of the host space's :meth:`_sketch_vals` rows),
    mapped to the host space's scale by its ``_sketch_post`` so proxy and
    exact values can be compared in a hybrid build. Exactness comes from
    the host space: the re-scored candidates of the build and the re-rank
    of a sketch-traversed beam (methods/hnsw.py)."""

    term_recompute = False
    name = "sketch_proxy"

    def __init__(self, dim: int, post=None):
        self.dim = dim
        self._post = post if post is not None else (lambda s: s)

    def pass1_affine(self):
        return (-1.0, 0.0, 0.0)

    def pass1_post(self, s, qenc):
        return self._post(s)

    def rows_as_queries(self, rows):
        return {"q": rows}

    def corpus_dict(self, data) -> dict:
        return {"vecs": data.vecs, "pad": data.extra["pad"], "count": data.count}

    def block(self, qenc, xc, precision: str = "float32"):
        s = D.negdot_blocked(qenc["q"], xc["x"], precision)
        return self._post(s) + xc["pad"][None, :]


class SparseSpaceBase(Space):
    """Shared encode machinery for the sparse float spaces."""

    data_kind = DataKind.SPARSE
    dist_kind = DistKind.FLOAT
    @property
    def preferred_chunk(self) -> int:
        """Corpus rows a scan step scores: tpu_knn's 256 on the CPU,
        :data:`CARD_CHUNK` on the card, where 256-row steps leave the scan
        bound by the host's launch rate."""
        return 256 if self.device.type == "cpu" else CARD_CHUNK

    #: tpu_knn's preferred chunk on every device: a method whose results
    #: depend on its chunk (NAPP's gather route) plans with it
    reference_chunk = 256

    #: The exact scan stays single pass: its two-pass route re-scores
    #: [Q, kg*128, nnz] gathered candidates for nothing a sparse pass 1
    #: could save (methods/seq_search.py _plan_knn).
    twopass_ok = False
    binary = False  # presence-only variants force values to 1
    #: distances that factor through dots or intersection counts carry
    #: the vocabulary gate and use the densified query tables
    dense_dot_ok = False
    #: per-query orders that factor through <q, x> allow the sketch proxy
    sketch_ok = False

    def _sketch_vals(self, col, val, length):
        """Values to project for the sketch (per-space normalization so that
        -<s_q, s_x> keeps this space's per-query order)."""
        return val

    def _sketch_post(self, s):
        """Monotone map from the -dot estimate to this space's scale."""
        return s

    def sketch_proxy(self, data: SparseDeviceData, dsk: int, seed: int, r_mat=None):
        """(proxy_space, proxy_data, R) for the graph methods, or None when
        the space has no dot-factored order or the corpus no vocabulary
        gate. ``r_mat`` (host f32[V_pad, dskp]) replaces the drawn R: a
        test hook that holds a proxy build to another package's matrix."""
        if not self.sketch_ok or "vocab_mark" not in data.extra:
            return None
        v_pad = data.extra["vocab_mark"].shape[0]
        dskp = round_up(max(dsk, 128), 128)
        if r_mat is None:
            r_mat = S.sketch_matrix(v_pad, dskp, seed, self.device)
        else:
            r_mat = torch.as_tensor(np.asarray(r_mat, np.float32), device=self.device)
            if tuple(r_mat.shape) != (v_pad, dskp):
                raise InvalidArgumentError(f"sketch matrix is {tuple(r_mat.shape)}, not {(v_pad, dskp)}")
        vecs = S.sketch_csr(data.col, self._sketch_vals(data.col, data.val, data.length), r_mat)
        pdata = DenseDeviceData(vecs=vecs, ids=data.ids, count=data.count, dim=dskp)
        pdata.extra["pad"] = data.extra["pad"]
        return SketchProxySpace(dskp, self._sketch_post), pdata, r_mat

    def sketch_queries(self, qenc: dict, r_mat) -> dict:
        """Proxy query encodings from encoded CSR queries. Query ids beyond
        the corpus vocabulary drop out of the projection (they match no
        corpus id; the cosine normalization still uses the full norm)."""
        vals = self._sketch_vals(qenc["qcol"], qenc["qval"], qenc["qlen"])
        return {"q": S.sketch_csr(qenc["qcol"], vals, r_mat)}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def encode_dataset(self, store: DataStore, row_multiple: int = 8, vocab_floor: int = 0) -> SparseDeviceData:
        pts = store.sparse_points()
        n = len(pts)
        n_pad = round_up(max(n, 1), row_multiple)
        with tracing.span("spaces.pack"):
            col, val, length = _pack_csr(pts, n_pad)
        if self.binary:
            val = (np.abs(val) > 0).astype(np.float32)
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = np.full(n_pad, -1, np.int32)
        ids[:n] = np.asarray(store.ids, np.int32)
        data = SparseDeviceData(
            col=self._upload(col), val=self._upload(val), length=self._upload(length),
            ids=self._upload(ids), count=n,
        )
        data.extra["pad"] = self._upload(pad)
        # the vocabulary gate travels with the corpus, never on the space:
        # every scoring site sizes its tables from the corpus it scores.
        # vocab_floor: a lower bound that gives independent encodes one width
        vmax = max(int(max((int(p.ids[-1]) for p in pts if len(p.ids)), default=0)), int(vocab_floor))
        if self.dense_dot_ok and 0 < vmax <= VOCAB_DENSE_MAX:
            data.extra["vocab_mark"] = torch.zeros(round_up(vmax, 128), dtype=torch.int8, device=self.device)
        return data

    def encode_queries(self, points) -> dict:
        pts = [p if isinstance(p, SparsePoint) else DataStore.validate_sparse(p) for p in points]
        col, val, length = _pack_csr(pts, len(pts), pad_col=S.PAD_Q)
        if self.binary:
            val = (np.abs(val) > 0).astype(np.float32)
        enc = {"qcol": self._upload(col), "qval": self._upload(val), "qlen": self._upload(length)}
        # the densified tables are built at each scoring site from the
        # corpus's own vocab_mark width (densify_queries), never here
        self._add_query_terms(enc, val, length)
        return enc

    def _add_query_terms(self, enc: dict, val: np.ndarray, length: np.ndarray) -> None:
        pass

    def _qdense_values(self, qval: torch.Tensor) -> torch.Tensor:
        """Values of the densified query tables and of the postings
        (presence indicators for jaccard)."""
        return qval

    def densify_queries(self, qenc: dict, corpus: dict, scan: bool = False) -> dict:
        """Attach the query side sized from the scored corpus's vocab_mark:
        ``q_dense`` f32[Q, V_pad], the densified table, for gathered
        candidates, or with ``scan`` ``q_post``, the batch's term-major
        postings (ops/sparse.Postings, one sort on the device; no [V, Q]
        table), for a scan of shared rows. Query ids beyond the vocabulary
        drop out, which is exact: no corpus id matches them. No-op without
        the gate or when the batch's own is there (postings of another
        batch, width or device are built anew)."""
        vm = corpus.get("vocab_mark")
        if vm is None or "qcol" not in qenc:
            return qenc
        col = qenc["qcol"]
        if scan:
            post = qenc.get("q_post")
            if post is not None and (post.v, post.nq, post.device) == (vm.shape[0], col.shape[0], col.device):
                return qenc
            return {**qenc, "q_post": S.postings(col, self._qdense_values(qenc["qval"]), vm.shape[0])}
        if "q_dense" in qenc:
            return qenc
        return {**qenc, "q_dense": S.densify(col, self._qdense_values(qenc["qval"]), vm.shape[0])}

    def slice_data(self, data: SparseDeviceData, start: int, size: int) -> dict:
        sl = slice(start, start + size)
        xc = {"x": data.val[sl], "cols": data.col[sl], "len": data.length[sl], "pad": data.extra["pad"][sl]}
        if "vocab_mark" in data.extra:
            xc["vocab_mark"] = data.extra["vocab_mark"]  # width carrier, unsliced
        return xc

    def corpus_dict(self, data: SparseDeviceData) -> dict:
        """Graph-search corpus tensors, row-indexed (ops/graph.py gathers
        'vecs' and the extra rowed keys 'cols' and 'len'); vocab_mark rides
        along ungathered."""
        out = {"vecs": data.val, "cols": data.col, "len": data.length, "pad": data.extra["pad"],
               "count": data.count}
        if "row_mask" in data.extra:
            out["row_mask"] = data.extra["row_mask"]
        if "vocab_mark" in data.extra:
            out["vocab_mark"] = data.extra["vocab_mark"]
        return out

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        """Distances f32[Q, C] of a query batch to a slice of corpus rows."""
        return self._block_impl(qenc, xc) + xc["pad"][None, :]

    def _block_impl(self, qenc, xc):
        raise NotImplementedError

    def gathered_block(self, qenc, rows, pad, extra):
        """Distances f32[B, K] of query b to its own gathered candidate rows
        (vals [B, K, nnz], extra 'cols'/'len' alike)."""
        return self._gathered_impl(qenc, rows, extra) + pad

    def pair_block(self, qe, rows, pad, extra, v_pad: int):
        """Distances [B, C, C2] of per-row candidate sets for the
        construction heuristic: the a-side encodings ``qe`` (qcol [B, C, T]
        ...) against gathered rows [B, C2, nnz]."""
        return self._pair_impl(qe, rows, extra, v_pad) + pad[:, None, :]


# ---------------- scalar-product family ----------------


class SparseDotBase(SparseSpaceBase):
    dense_dot_ok = True
    sketch_ok = True  # raw-value sketches: -<s_q,s_x> orders like -<q,x>
    #: the space's post of its dots (ops/sparse.dot_post, qdense_dists)
    qdense_form = ""

    def densify_queries(self, qenc: dict, corpus: dict, scan: bool = False) -> dict:
        """As the base class; a scan's postings also bring the query norms
        ``qnorm`` f32[Q], once a scan, not once a block."""
        qenc = super().densify_queries(qenc, corpus, scan)
        if scan and "q_post" in qenc and "qnorm" not in qenc:
            qenc = {**qenc, "qnorm": S.norms_from_vals(qenc["qval"])}
        return qenc

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        """Distances f32[Q, C] against shared rows: one ops/sparse
        qdense_dists call through the batch's postings (built on the spot
        when the caller did not attach them), the hand-written kernel on
        the card; the binary-search lookup when the corpus has no
        vocabulary gate."""
        qenc = self.densify_queries(qenc, xc, scan=True)
        if "q_post" in qenc:
            return S.qdense_dists(self.qdense_form, qenc["q_post"], xc["cols"], xc["x"], qenc["qnorm"], None,
                                  None, xc["pad"])
        return super().block(qenc, xc, precision)

    def _block_impl(self, qenc, xc):
        dot = S.lookup_dot_blocked(qenc["qcol"], qenc["qval"], xc["cols"], xc["x"])
        qn = S.norms_from_vals(qenc["qval"])[:, None]
        xn = S.norms_from_vals(xc["x"])[None, :]
        return self._post_dot(dot, qn, xn)

    def _gathered_impl(self, qenc, rows, extra):
        cols = extra["cols"]
        qenc = self.densify_queries(qenc, extra)
        if "q_dense" in qenc:
            dot = S.gathered_dot(qenc["q_dense"], cols, rows)
        else:
            vals, _ = S.lookup_query_vals(qenc["qcol"], qenc["qval"], cols)
            dot = torch.sum(vals * rows, dim=-1)
        qn = S.norms_from_vals(qenc["qval"])[:, None]
        return self._post_dot(dot, qn, S.norms_from_vals(rows))

    def _pair_impl(self, qe, rows, extra, v_pad):
        dot = S.pair_dots(qe["qcol"], qe["qval"], extra["cols"], rows)
        an = S.norms_from_vals(qe["qval"])[:, :, None]
        bn = S.norms_from_vals(rows)[:, None, :]
        return self._post_dot(dot, an, bn)

    def _post_dot(self, dot, qn, xn):
        """The space's distance from the dot and the two norms (broadcast)."""
        return S.dot_post(self.qdense_form, dot, qn, xn)


def _unit_rows(val):
    return val / torch.clamp_min(S.norms_from_vals(val), S.TINY)[..., None]


@register_space("cosinesimil_sparse")
@register_space("cosinesimil_sparse_fast")
class SparseCosineSpace(SparseDotBase):
    """max(0, 1 - dot/(|q||x|)) (reference: CosineSimilarity,
    src/distcomp_scalar.cc:268-273)."""

    name = "cosinesimil_sparse"
    qdense_form = "cosine"

    def _sketch_vals(self, col, val, length):
        # for a fixed query, 1 - <q,x>/(|q||x|) orders like -<q, x/|x|>
        return _unit_rows(val)

    def _sketch_post(self, s):
        return torch.clamp_min(1.0 + s, 0.0)  # s = -cos estimate


@register_space("cosinesimil_sparse_bin_fast")
class SparseCosineBinSpace(SparseCosineSpace):
    name = "cosinesimil_sparse_bin_fast"
    binary = True


@register_space("angulardist_sparse")
@register_space("angulardist_sparse_fast")
class SparseAngularSpace(SparseDotBase):
    """acos(clip(dot/(|q||x|), -1, 1)) (reference: AngularDistance)."""

    name = "angulardist_sparse"
    qdense_form = "angular"

    def _sketch_vals(self, col, val, length):
        return _unit_rows(val)

    def _sketch_post(self, s):
        return torch.arccos(torch.clamp(-s, -1.0, 1.0))


@register_space("negdotprod_sparse")
@register_space("negdotprod_sparse_fast")
class SparseNegDotSpace(SparseDotBase):
    name = "negdotprod_sparse"
    qdense_form = "negdot"


@register_space("negdotprod_sparse_bin_fast")
class SparseNegDotBinSpace(SparseNegDotSpace):
    name = "negdotprod_sparse_bin_fast"
    binary = True


@register_space("querynorm_negdotprod_sparse")
@register_space("querynorm_negdotprod_sparse_fast")
class SparseQueryNormNegDotSpace(SparseDotBase):
    """-dot(x, q)/|q|: QueryNormScalarProduct normalizes by the query
    argument only (reference: src/distcomp_scalar.cc:64-79)."""

    name = "querynorm_negdotprod_sparse"
    qdense_form = "querynorm"


# ---------------- Lp family ----------------


class SparseLpBase(SparseSpaceBase):
    """Union-of-supports Lp (reference: space_sparse_lp.h merge loops)."""

    p: float = 2.0

    def _add_query_terms(self, enc, val, length):
        if not math.isinf(self.p):
            enc["q_pterm"] = self._upload(np.sum(np.abs(val) ** self.p, axis=1).astype(np.float32))

    def _finish(self, d):
        if math.isinf(self.p):
            return d
        d = torch.clamp_min(d, 0.0)
        return d if self.p == 1.0 else d ** (1.0 / self.p)

    def _block_impl(self, qenc, xc):
        if math.isinf(self.p):
            return S.linf_union_blocked(qenc["qcol"], qenc["qval"], xc["cols"], xc["x"])
        return self._finish(S.lp_union_blocked(qenc["qcol"], qenc["qval"], xc["cols"], xc["x"], self.p,
                                               qenc["q_pterm"]))

    def _gathered_impl(self, qenc, rows, extra):
        return self._block_impl(qenc, {"cols": extra["cols"], "x": rows})

    def _pair_impl(self, qe, rows, extra, v_pad):
        if math.isinf(self.p):
            return S.pair_linf(qe["qcol"], qe["qval"], extra["cols"], rows)
        return self._finish(S.pair_lp(qe["qcol"], qe["qval"], extra["cols"], rows, self.p, qe["q_pterm"]))


@register_space("l1_sparse")
class SparseL1Space(SparseLpBase):
    name = "l1_sparse"
    p = 1.0


@register_space("l2_sparse")
class SparseL2Space(SparseLpBase):
    name = "l2_sparse"
    p = 2.0


@register_space("linf_sparse")
class SparseLinfSpace(SparseLpBase):
    name = "linf_sparse"
    p = math.inf


@register_space("lp_sparse")
class SparseLpSpace(SparseLpBase):
    name = "lp_sparse"

    def __init__(self, params: Params | None = None, device="cpu"):
        pm = ParamManager(params)
        p = pm.get("p", 2.0, float)
        pm.check_unused()
        if p <= 0:
            raise InvalidArgumentError("lp_sparse requires p > 0")
        super().__init__(params, device)
        self.p = p


# ---------------- Jaccard ----------------


@register_space("jaccard_sparse")  # C++ registry spelling (space_sparse_jaccard.h:31)
@register_space("sparse_jaccard")  # Zig-whitelist spelling
class SparseJaccardSpace(SparseSpaceBase):
    """1 - |A n B|/|A u B| over sorted id sets; values ignored (reference:
    space_sparse_jaccard.h, distcomp.h:253-262)."""

    name = "sparse_jaccard"
    dense_dot_ok = True  # intersection counts through the presence tables
    sketch_ok = True

    def _sketch_vals(self, col, val, length):
        # normalized presence indicators: -<s_a, s_b> approximates the order
        # of -|A n B|/sqrt(|A||B|); the exact re-rank restores jaccard
        ind = ((col >= 1) & (col < S.PAD_X)).float()
        return ind / torch.clamp_min(torch.sqrt(length.float()), 1.0)[..., None]

    def _sketch_post(self, s):
        return torch.clamp(1.0 + s, 0.0, 1.0)

    def _qdense_values(self, qval):
        return torch.ones_like(qval)

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        """Distances f32[Q, C] against shared rows: one ops/sparse
        qdense_dists call through the batch's presence postings (the
        hand-written kernel on the card); the binary-search lookup when
        the corpus has no vocabulary gate."""
        qenc = self.densify_queries(qenc, xc, scan=True)
        if "q_post" in qenc:
            return S.qdense_dists("jaccard", qenc["q_post"], xc["cols"], None, None, qenc["qlen"], xc["len"],
                                  xc["pad"])
        return super().block(qenc, xc, precision)

    def _block_impl(self, qenc, xc):
        inter = S.lookup_dot_blocked(qenc["qcol"], torch.ones_like(qenc["qval"]), xc["cols"],
                                     S.real_slots(xc["cols"]))
        return S.jaccard_from_counts(inter, qenc["qlen"][:, None], xc["len"][None, :])

    def _gathered_impl(self, qenc, rows, extra):
        cols = extra["cols"]
        qenc = self.densify_queries(qenc, extra)
        if "q_dense" in qenc:
            inter = S.gathered_found(qenc["q_dense"], cols)
        else:
            _, found = S.lookup_query_vals(qenc["qcol"], qenc["qval"], cols)
            inter = torch.sum(found.float(), dim=-1)
        return S.jaccard_from_counts(inter, qenc["qlen"][:, None], extra["len"])

    def _pair_impl(self, qe, rows, extra, v_pad):
        inter = S.pair_intersect(qe["qcol"], extra["cols"])
        return S.jaccard_from_counts(inter, qe["qlen"][:, :, None], extra["len"][:, None, :])
