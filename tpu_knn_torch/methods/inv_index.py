"""simple_invindx: top-k retrieval over sparse vectors by posting lists
(counterpart of tpu_knn/methods/inv_index.py; reference:
include/method/simple_inverted_index.h, src/method/simple_inverted_index.cc).

The reference builds per-term posting lists sorted by doc id and merges
them document-at-a-time with a heap, accumulating query-value x doc-value
products; it works ONLY with the negdotprod_sparse_fast space
(simple_inverted_index.h:40-50) and only answers kNN (range throws).

Here it is the term-at-a-time engine of ops/inverted.py: 128-aligned
posting blocks, a host batch plan, block gathers and an ordered
accumulation, whose cost per query follows the query's posting mass like
the reference's DAAT, not the corpus size. ``dist_comps`` counts the
documents with a non-zero accumulated score (what DAAT touches); results
hold only such documents, as a DAAT heap never sees a document that shares
no term with the query. tpu_knn's ``INVINDX_BACKEND="scan"`` arm and its
packed transport are A/B and tunnel residue and are not ported.
"""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataStore, SparsePoint, round_up
from ..core.errors import IndexNotBuiltError, SpaceIncompatibleError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import inverted as IV
from ..ops import sparse as S
from ..spaces.sparse import _pack_csr
from .base import Method

#: tpu_knn's corpus chunk for this method (its sparse spaces' preferred
#: chunk); it pads the corpus, and so sizes the accumulator, alike on both
#: devices.
CHUNK = 256
#: Accumulator rows per step of the top-k pass. tpu_knn takes the widest
#: divisor of the padded row count (``_taat_tchunk``: equal slices for
#: lax.dynamic_slice), which is 256 at 1,000,000 rows (1,000,192 = 3,907 x
#: 256), and 3,907 merges a batch were bound by the launch rate on an H100;
#: the port streams 8192-row slices with a ragged last one, for the same
#: results.
TOPK_CHUNK = 8192


@register_method("simple_invindx")
class SimpleInvIndex(Method):
    name = "simple_invindx"
    supports_range = False  # "Range search is not supported!" (reference)

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        if space.name not in ("negdotprod_sparse", "negdotprod_sparse_fast"):
            raise SpaceIncompatibleError(
                "The method simple_invindx works only with the space negdotprod_sparse_fast"
            )
        pm = ParamManager(self.index_params)
        pm.get("dummyParam", 0, int)  # the reference's only index param
        pm.check_unused()
        self._inv = None

    def set_query_time_params(self, params: Params | None) -> None:
        pm = ParamManager(Params.of(params))
        pm.get("dummyParam", 0, int)
        pm.check_unused()
        super().set_query_time_params(params)

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        self._chunk = round_up(min(CHUNK, round_up(max(len(store), 1), 8)), 8)
        self.data = self.space.encode_dataset(store, row_multiple=self._chunk)
        # the posting directory (host CSC build over the padded-CSR host
        # arrays; simple_inverted_index.cc:96-118 CreateIndex analog)
        self._inv = IV.build_postings(
            self.data.col.cpu().numpy(), self.data.val.cpu().numpy(),
            self.data.count, int(self.data.ids.shape[0]), self.data.ids.device,
        )

    def _host_queries(self, points):
        """Query rows as host padded CSR (qcol, qval): the batch plan is
        host work."""
        pts = [p if isinstance(p, SparsePoint) else DataStore.validate_sparse(p) for p in points]
        col, val, _ = _pack_csr(pts, len(pts), pad_col=S.PAD_Q)
        return col, val

    def _taat_dispatch(self, points, k: int):
        """Run the TAAT engine; returns a zero-arg finisher."""
        qcol, qval = self._host_queries(points)
        block_ids, ublock, w = IV.plan_batch(qcol, qval, self._inv)
        kk = min(k, self._inv.n_rows)  # a top-k merge needs k <= rows
        d, ids, nd = IV.taat_topk(self._inv.pdoc_blocks, self._inv.pval_blocks, block_ids, ublock, w,
                                  self.data.ids, kk, TOPK_CHUNK)
        self._add_dist_comps(nd)
        return lambda: self._taat_finalize(d.cpu().numpy(), ids.cpu().numpy(), k, kk)

    def _taat_finalize(self, d, ids, k: int, kk: int):
        if kk < k:
            d = np.pad(d, ((0, 0), (0, k - kk)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        return self._finalize_knn(d, ids)

    def knn(self, points, k: int):
        return self.knn_async(points, k)()

    def knn_async(self, points, k: int):
        """Dispatch now, read the results to the host when called."""
        if self.data is None:
            raise IndexNotBuiltError("simple_invindx: index not built")
        return self._taat_dispatch(points, k)
