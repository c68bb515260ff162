"""SW-graph (small_world_rand): a single-layer navigable small-world graph
(counterpart of tpu_knn/methods/sw_graph.py; reference:
include/method/small_world_rand.h, src/method/small_world_rand.cc; Malkov
et al. 2014).

The single layer is HNSW's level 0, so this reuses the wave build and the
batched beam search with no upper levels (every level sampled as 0). The
reference's unbounded sorted friend lists become a padded adjacency row of
``maxFriends`` (default 4*NN) with heuristic shrink on overflow, as in
tpu_knn.

This is the only method with incremental maintenance (reference:
small_world_rand.cc:141-338):

  * ``add_batch``: the new rows are inserted by the same waves against the
    frozen existing graph (AddBatch);
  * ``delete_batch``, after ``DeleteStrategy`` (small_world_rand.h:80-152):
      - "none": drop the deleted nodes and every link to them;
      - "neighbors_only": also patch each surviving node's deleted links
        with the deleted node's closest surviving friend
        (removeGivenFriendsPatchWithClosestNeighbor), a friend at most
        once (tpu_knn can link one twice; see _patch_links).
    Deleted rows stay allocated but masked (+inf row term, id -1, and a
    'row_mask' the graph's gathers read); external ids stay stable.

Level 0 is edited on the host as a copy (``.cpu().numpy().copy()``), never
through a view of the device tensor, and goes back as a new tensor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.dataset import DataStore
from ..core.errors import IndexNotBuiltError, InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from .hnsw import Hnsw, _corpus_dict, _score_pairs


@register_method("sw-graph")
@register_method("small_world_rand")
class SmallWorldRand(Hnsw):
    name = "sw-graph"
    supports_range = False
    supports_incremental = True
    # delete_batch re-scores pairs with the wave encodings after the build
    # (_patch_links), so the construction state survives the build
    KEEP_WAVE_STATE = True

    def __init__(self, space, params: Params | None = None):
        pm = ParamManager(Params.of(params))
        nn = pm.get("NN", 10, int)
        efc = pm.get_synonym(["efConstruction", "initIndexAttempts"], nn, int)
        max_friends = pm.get("maxFriends", 4 * nn, int)
        pm.get("initSearchAttempts", 1, int)  # parity no-op (batched search)
        pm.get("indexThreadQty", 0, int)  # parity no-op: waves batch instead
        pm.get("useProxyDist", False, bool)  # parity no-op: no proxy distances
        wave = pm.get("waveSize", 256, int)
        wave_mates = pm.get("waveMates", 8, int)
        expand = pm.get("searchExpand", 4, int)
        c_expand = pm.get("constructionExpand", 4, int)
        seed = pm.get("seed", 0, int)
        delaunay = pm.get("delaunay_type", 2, int)
        pm.check_unused()
        super().__init__(
            space,
            Params(
                M=nn,
                maxM0=max_friends,
                efConstruction=efc,
                mult=0.0,  # every point on level 0: one layer
                delaunay_type=delaunay,
                waveSize=wave,
                waveMates=wave_mates,
                searchExpand=expand,
                constructionExpand=c_expand,
                seed=seed,
                # the insertion waves: deletion patching reads their state
                buildAlgo="waves",
            ),
        )
        self.nn = nn
        # query-time default efSearch = NN (reference: small_world_rand.cc:366-427)
        self.ef_search = nn
        self.DEFAULT_EF_SEARCH = nn
        self._deleted: np.ndarray | None = None

    def _sample_levels(self, n: int, rng) -> np.ndarray:
        return np.zeros(max(n, 1), np.int32)[:n]

    # ---------------- incremental addition ----------------

    def add_batch(self, store: DataStore, new_positions: Sequence[int]) -> None:
        """Insert the store's new tail into the existing graph (reference:
        SmallWorldRand::AddBatch, small_world_rand.cc:141)."""
        if self.graph is None:
            self.create_index(store, self.index_params)
            return
        old_n = self._n_total
        n = len(store)
        if n <= old_n:
            return
        old_deleted = self._deleted
        self.store = store
        # one layer: the insertion order is the identity
        self.order = np.arange(n)
        self.levels = np.zeros(n, np.int32)
        old_level0 = self.graph["level0"]
        self._encode_store(store, n)
        n_pad = self.data.ids.shape[0]
        level0 = torch.full((n_pad, self.maxM0), -1, dtype=torch.int32, device=old_level0.device)
        level0[: old_level0.shape[0]] = old_level0
        self.graph = {"level0": level0}
        self._upper = []
        self._max_level = 0
        if old_deleted is not None:
            self._deleted = np.concatenate([old_deleted, np.zeros(n - old_n, bool)])
            self._mask_deleted_rows()
        self._run_waves(old_n, n)

    # ---------------- deletion ----------------

    def delete_batch(self, positions: Sequence[int], strategy: str = "none") -> None:
        """Remove nodes by store position (reference: DeleteBatch,
        small_world_rand.cc:232-338)."""
        if self.graph is None:
            raise IndexNotBuiltError("sw-graph: index not built")
        if strategy not in ("none", "neighbors_only"):
            raise InvalidArgumentError(f"unknown delete strategy {strategy!r}; use 'none' or 'neighbors_only'")
        n = self._n_total
        pos = np.asarray(list(positions), np.int64)
        if pos.size == 0:
            return
        if pos.min() < 0 or pos.max() >= n:
            raise InvalidArgumentError("delete position out of range")
        if self._deleted is None:
            self._deleted = np.zeros(n, bool)
        self._deleted[pos] = True

        adj = self.graph["level0"].cpu().numpy().copy()  # [n_pad, cap], edited on the host
        deleted_full = np.zeros(adj.shape[0], bool)
        deleted_full[:n] = self._deleted
        is_del_link = (adj >= 0) & deleted_full[np.clip(adj, 0, adj.shape[0] - 1)]
        if strategy == "neighbors_only":
            adj = self._patch_links(adj, is_del_link, deleted_full)
        else:
            adj = np.where(is_del_link, -1, adj)
        adj[deleted_full] = -1
        self.graph = {"level0": torch.from_numpy(adj).to(self.graph["level0"].device)}
        self._mask_deleted_rows()
        # move the entry point off a deleted node (the reference keeps a live
        # entry element the same way)
        if self._deleted[self._entry]:
            surv = np.nonzero(~self._deleted)[0]
            self._entry = int(surv[0]) if surv.size else 0

    def _patch_links(self, adj: np.ndarray, is_del_link: np.ndarray, deleted_full: np.ndarray) -> np.ndarray:
        """For each surviving node u with a deleted friend d, replace that
        link with d's closest surviving friend (closest to u), as in
        removeGivenFriendsPatchWithClosestNeighbor (small_world_rand.h:101-152)."""
        u_idx, slot_idx = np.nonzero(is_del_link & ~deleted_full[:, None])
        if u_idx.size == 0:
            return np.where(is_del_link, -1, adj)
        d_idx = adj[u_idx, slot_idx]
        cand = adj[d_idx]  # [P, cap]: the deleted nodes' friends
        cand_ok = (cand >= 0) & ~deleted_full[np.clip(cand, 0, adj.shape[0] - 1)]
        cand_m = np.where(cand_ok, cand, -1)
        # scored in the GRAPH space: the wave encodings are the proxy's when a
        # sparse build used one, and "closest" is an ordering the proxy keeps
        dev = self.graph["level0"].device
        corpus = _corpus_dict(self._graph_space, self._graph_data)
        d = _score_pairs(
            self._graph_space, self._qenc_all, self._n_total, corpus,
            torch.from_numpy(u_idx[:, None].astype(np.int32)).to(dev),
            torch.from_numpy(cand_m.astype(np.int32)).to(dev),
        )[:, 0, :].cpu().numpy()
        # no link back to the node itself or to a friend it already has
        d = np.where(cand_m == u_idx[:, None], np.inf, d)
        already = (cand_m[:, :, None] == adj[u_idx][:, None, :]).any(axis=2)
        d = np.where(already, np.inf, d)
        best = np.argmin(d, axis=1)
        best_d = d[np.arange(len(best)), best]
        repl = np.where(np.isfinite(best_d), cand_m[np.arange(len(best)), best], -1)
        out = np.where(is_del_link, -1, adj)
        out[u_idx, slot_idx] = repl
        # two deleted friends of u may pick the same replacement: the
        # reference's link() never adds a friend twice, so only the first
        # slot keeps it and the others are freed (tpu_knn keeps every copy,
        # a duplicate link that check_graph counts)
        key = u_idx.astype(np.int64) * (adj.shape[0] + 1) + repl
        dup = np.ones(key.shape[0], bool)
        dup[np.unique(key, return_index=True)[1]] = False
        dup &= repl >= 0
        out[u_idx[dup], slot_idx[dup]] = -1
        # reverse edges repl -> u into free slots (link() adds both ways), in
        # tpu_knn's order: the graph depends on it
        for p in np.argsort(repl):
            r, u = repl[p], u_idx[p]
            if r < 0:
                continue
            row = out[r]
            if (row == u).any():
                continue
            free = np.nonzero(row < 0)[0]
            if free.size:
                out[r, free[0]] = u
        return out

    def _mask_deleted_rows(self) -> None:
        """Mask the deleted rows: +inf row term, id -1, and a 'row_mask' that
        the gather paths read instead of the static count."""
        if self._deleted is None or not self._deleted.any():
            return
        dev = self.data.ids.device
        delf = torch.zeros(self.data.ids.shape[0], dtype=torch.bool)
        delf[: self._n_total] = torch.from_numpy(self._deleted)
        delf = delf.to(dev)
        pad = torch.where(delf, torch.tensor(1e30, dtype=torch.float32, device=dev), self.data.extra["pad"])
        self.data.extra["pad"] = pad
        self.data.extra["row_mask"] = pad
        self.data.ids = torch.where(delf, torch.tensor(-1, dtype=torch.int32, device=dev), self.data.ids)

    def data_qty(self) -> int:
        n = self._n_total if self.graph is not None else len(self.store or [])
        return n - int(self._deleted.sum()) if self._deleted is not None else n

    # ---------------- persistence ----------------

    def state_arrays(self) -> dict:
        out = super().state_arrays()
        if self._deleted is not None:
            out["deleted"] = self._deleted.astype(np.int8)
        return out

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        super().restore(store, state, params)
        if "deleted" in state:
            self._deleted = np.asarray(state["deleted"]).astype(bool)
            self._mask_deleted_rows()
