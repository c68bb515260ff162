"""Corpus-sharded HNSW: one subgraph per shard (counterpart of
tpu_knn/parallel/hnsw_sharded.py).

The corpus is split into balanced contiguous shards; each shard gets its
own HNSW (methods/hnsw.py) with seed ``seed + si``. The shard's encoded
corpus and graph live on ``mesh.device(si)``, padded to the shapes every
shard shares (the padding values of :func:`_stack_fill`), as tpu_knn
stacks them on a leading shard axis. A query batch runs the upper-level
greedy descent and the batched beam search on every shard, and the
per-shard top-k merge on the first shard's device.

Build routes, decided per shard size as tpu_knn decides them:

  * ``parallelBuild=1`` (default): every shard is prepared, then the
    insertion waves run over all shards with ONE schedule, that of the
    largest shard (:meth:`ShardedHnsw._run_stacked_waves`): tpu_knn runs
    it as one shard_map program; the port loops over the shards inside
    each wave, so the graphs are tpu_knn's stacked graphs;
  * ``parallelBuild=0``: each shard runs the single-device build
    (:meth:`ShardedHnsw._build_sequential`), with its own schedule;
  * ``buildAlgo="nndescent"`` (or ``"auto"`` from buildAlgoAutoN rows per
    shard): NN-descent per shard through the single-device pipeline.

A sparse corpus builds on one shared JL-sketch proxy: every shard
encodes to the whole corpus's vocabulary width and draws R from the same
seed (:meth:`ShardedHnsw._configure_shard`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore
from ..core.errors import InvalidArgumentError, RuntimeNmsError
from ..core.params import ParamManager, Params, _convert
from ..methods.base import RESULT_DIST_CUTOFF, Method
from ..methods.hnsw import Hnsw, make_wave_step
from ..ops import graph as G
from ..ops.sparse import PAD_Q, PAD_X
from ..utils.logging import log
from .mesh import Mesh
from .sharded import merge_sharded_topk, qenc_to


def _pad_to_shape(a: torch.Tensor, shape: tuple, fill) -> torch.Tensor:
    """Pad every axis of ``a`` up to ``shape`` with ``fill``. Per-shard
    encodes differ in padded widths (sparse nnz_max, padded vocabulary);
    the fill is the layout's own padding value, so widened rows stay
    inert."""
    if tuple(a.shape) == tuple(shape):
        return a
    out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _stack_fill(key: str):
    """Padding value per corpus / query-encoding key (sparse layouts:
    ops/sparse.py PAD_Q/PAD_X; masks pad with +big)."""
    if key in ("pad", "row_mask"):
        return 1e30
    if key == "cols":
        return int(PAD_X)
    if key == "qcol":
        return int(PAD_Q)
    return 0


def _subset_store(store: DataStore, lo: int, hi: int, dense_mat=None) -> DataStore:
    """Store positions [lo, hi). ``dense_mat``: ``store.dense_matrix()``
    hoisted out of a per-shard loop (it re-stacks the whole corpus)."""
    sub = DataStore(store.kind)
    ids = store.ids[lo:hi]
    if store.kind in (DataKind.DENSE, DataKind.UINT8):
        mat = (dense_mat if dense_mat is not None else store.dense_matrix())[lo:hi]
        if store.kind is DataKind.DENSE:
            labels = store.labels[lo:hi] if store.labels else None
            sub.add_dense_batch(mat, ids, labels=labels)
        else:
            sub.add_uint8_batch(mat, ids)
    elif store.kind is DataKind.SPARSE:
        sub.add_sparse_batch(store.sparse_points()[lo:hi], ids)
    else:
        sub.add_string_batch(store.strings()[lo:hi], ids)
    return sub


def _with_spare(adj: torch.Tensor) -> torch.Tensor:
    """make_wave_step's spare last row (the target of dropped scatters)."""
    return torch.cat([adj, adj.new_full((1, adj.shape[1]), -1)])


class ShardedHnsw(Method):
    """S per-shard HNSW graphs under one mesh, behind
    ``Index(..., method="hnsw", mesh=...)``."""

    name = "hnsw"
    supports_range = False
    supports_incremental = False
    progress = False

    #: method default efSearch and expansion (methods/hnsw.py)
    DEFAULT_EF_SEARCH = 20
    DEFAULT_EXPAND = 4

    def __init__(self, space, mesh: Mesh, index_params: Params | None = None):
        super().__init__(space, index_params)
        self.mesh = mesh
        pm = Params.of(index_params)
        self.parallel_build = _convert(pm.get("parallelBuild", True), bool)
        self.build_algo = str(pm.get("buildAlgo", "auto"))
        if self.build_algo not in ("auto", "waves", "nndescent"):
            raise ValueError(f"bad buildAlgo {self.build_algo!r}")
        self.build_algo_auto_n = _convert(pm.get("buildAlgoAutoN", 300_000), int)
        d = pm.as_dict()
        d.pop("parallelBuild", None)
        self.params = Params(d)
        self.ef_search = self.DEFAULT_EF_SEARCH
        self.expand = self.DEFAULT_EXPAND
        #: per shard, on its device: {"corpus", "ids", "level0", "upper"}
        self._shards: list[dict] | None = None
        self._shard_meta: list[dict] = []  # per-shard host state (persistence)

    # ---------------- Method protocol ----------------

    @property
    def graph(self):
        """Every shard's level 0 and upper levels (lists, one per shard)."""
        if not self._shards:
            return None
        return {"level0": [sh["level0"] for sh in self._shards], "upper": [sh["upper"] for sh in self._shards]}

    def aux_device_arrays(self):
        if not self._shards:
            return ()
        return tuple(t for sh in self._shards for t in (sh["ids"], sh["level0"], *sh["upper"]))

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.build(store)

    def range(self, points, radius: float):
        raise RuntimeNmsError("sharded hnsw does not support range queries")

    def add_batch(self, store, new_positions):
        raise RuntimeNmsError("sharded hnsw does not support incremental addition")

    def delete_batch(self, positions, strategy="none"):
        raise RuntimeNmsError("sharded hnsw does not support deletion")

    # ---------------- build ----------------

    def _shard_bounds(self, n: int, s: int) -> list[tuple[int, int]]:
        """Balanced split: every shard non-empty whenever n >= s."""
        sizes = [n // s + (1 if i < n % s else 0) for i in range(s)]
        lo, out = 0, []
        for sz in sizes:
            out.append((lo, lo + sz))
            lo += sz
        return out

    def build(self, store: DataStore) -> None:
        self.store = store
        s = self.mesh.size
        n = len(store)
        bounds = self._shard_bounds(n, s)
        algo = self.build_algo
        if algo == "auto":
            # each shard is its own graph: the single-device threshold
            # applies to the shard size; sparse corpora stay on waves
            n_per = (n + s - 1) // max(s, 1)
            algo = (
                "nndescent"
                if n_per >= self.build_algo_auto_n and store.kind in (DataKind.DENSE, DataKind.UINT8)
                else "waves"
            )
        if algo == "nndescent":
            self._build_sequential(store, bounds, algo="nndescent")
        elif self.parallel_build and s > 1 and n >= s:
            self._build_parallel(store, bounds)
        else:
            self._build_sequential(store, bounds)

    @staticmethod
    def _dense_mat(store: DataStore):
        if store.kind in (DataKind.DENSE, DataKind.UINT8) and len(store):
            return store.dense_matrix()
        return None

    def _global_vocab_floor(self, store: DataStore) -> int:
        """The largest term id of the whole corpus, so every shard's sparse
        encode pads to one vocabulary width (ids are sorted per point)."""
        if store.kind is not DataKind.SPARSE:
            return 0
        return max((int(p.ids[-1]) for p in store.sparse_points() if len(p.ids)), default=0)

    def _configure_shard(self, h: Hnsw, vocab_floor: int) -> None:
        """Every shard encodes against the same padded vocabulary and seeds
        its JL sketch alike, so all shards share one R: sketches of
        different shards live in one proxy space and the waves see uniform
        widths."""
        h.vocab_floor = vocab_floor
        h.sketch_seed = int(self.params.get("seed", 0) or 0)

    def _seed(self, si: int) -> int:
        return int(self.params.get("seed", 0) or 0) + si

    def _build_sequential(self, store: DataStore, bounds, algo: str = "waves") -> None:
        vf = self._global_vocab_floor(store)
        mat = self._dense_mat(store)
        shards: list[Hnsw] = []
        for si, (lo, hi) in enumerate(bounds):
            h = Hnsw(self.space, Params.of(self.params, seed=self._seed(si), buildAlgo=algo))
            self._configure_shard(h, vf)
            h.create_index(_subset_store(store, lo, hi, mat))
            shards.append(h)
        self._stack(shards)

    def _build_parallel(self, store: DataStore, bounds) -> None:
        """Prepare every shard (level sampling, reorder, encode, empty
        graph), pad the states to common shapes, then run the insertion
        waves of all shards on one schedule."""
        vf = self._global_vocab_floor(store)
        mat = self._dense_mat(store)
        shards: list[Hnsw] = []
        for si, (lo, hi) in enumerate(bounds):
            # waves pinned: the schedule needs the corpus-as-queries
            # encodings that _prepare skips for an NN-descent shard
            h = Hnsw(self.space, Params.of(self.params, seed=self._seed(si), buildAlgo="waves"))
            self._configure_shard(h, vf)
            h._prepare(_subset_store(store, lo, hi, mat))
            shards.append(h)
        self._stack(shards)  # corpus/ids + the (empty) level0/upper
        self._run_stacked_waves(shards)
        log("DEBUG", f"sharded hnsw: parallel build of {len(shards)} shards done")

    def _run_stacked_waves(self, shards: list[Hnsw]) -> None:
        """The insertion waves of every shard on the largest shard's ramped
        schedule (methods/hnsw.py _run_waves): a smaller shard runs the
        same waves, the ones past its rows no-ops (their levels are -1)."""
        from ..methods.hnsw import WAVE_RAMP

        cfg = shards[0]
        s = len(shards)
        per = max(h._n_total for h in shards)
        w = int(min(cfg.wave, per))
        schedule: list[tuple[int, int]] = []
        pos = 0
        if w > 128 and w > per // 64 and WAVE_RAMP:
            ramp, sz = [128, 128], 256
            while sz <= w // 2:
                ramp.append(sz)
                sz *= 2
            for sz in ramp:
                sz = min(sz, per - pos)
                if sz <= 0:
                    break
                schedule.append((pos, sz))
                pos += sz
        while pos < per:
            schedule.append((pos, w))
            pos += w
        max_level = max(h._max_level for h in shards)

        # per-node query encodings, rows padded to a common count
        n_q = per
        qenc_st = self._stack_qenc([h._qenc_all for h in shards], shards, n_q)
        # a sparse corpus builds on its shards' shared-R sketch proxy, with
        # the sparse corpus along for the exact refinements
        use_proxy = shards[0]._proxy is not None
        st = self._shards
        if use_proxy:
            n_pad = max(h.data.ids.shape[0] for h in shards)
            build_corpus = self._stack_corpus(
                [self._corpus_with_mask(h._graph_space.corpus_dict(h._graph_data), h._graph_data.extra["pad"])
                 for h in shards],
                n_pad,
            )
            build_space = shards[0]._graph_space
        else:
            build_corpus = [sh["corpus"] for sh in st]
            build_space = self.space.construction_space()
        exact = use_proxy and shards[0]._exact_qenc_all is not None
        if exact:
            eqenc_st = self._stack_qenc([h._exact_qenc_all for h in shards], shards, n_q)
            ecorpus_st = [sh["corpus"] for sh in st]
        else:
            eqenc_st = ecorpus_st = [None] * s

        # per-shard levels over the padded wave range (-1: no-op rows)
        wl_width = max(off for off, _ in schedule) + w
        wl_st = []
        for si, h in enumerate(shards):
            wl = np.full(wl_width, -1, np.int32)
            wl[: len(h.levels)] = h.levels
            wl_st.append(torch.from_numpy(wl).to(self.mesh.device(si)))

        steps: dict = {}

        def get_step(width: int):
            if width not in steps:
                steps[width] = make_wave_step(
                    build_space, n_q, width, max_level,
                    efc=cfg.ef_construction, m=cfg.M, m0cap=cfg.maxM0, mcap=cfg.maxM,
                    mates=min(cfg.wave_mates, width), expand=cfg.construction_expand,
                    selection="none" if cfg.delaunay_type == 0 else "heur",
                    exact_space=self.space if exact else None,
                    exact_pairs=exact and bool(cfg.exact_pairs),
                    exact_base=bool(cfg.exact_base),
                )
            return steps[width]

        level0 = [_with_spare(sh["level0"]) for sh in st]
        upper = [[_with_spare(u) for u in sh["upper"]] for sh in st]

        def run(off: int, width: int, limit: int) -> None:
            for si in range(s):  # wave-major: distinct cards overlap
                get_step(width)(
                    level0[si], upper[si], off, wl_st[si][off:off + width], 0, limit,
                    build_corpus[si], qenc_st[si], ecorpus=ecorpus_st[si], eqenc_all=eqenc_st[si],
                )

        for off, width in schedule:
            run(off, width, off)  # frozen-prefix limit during the build
        for _ in range(cfg.post):
            for off, width in reversed(schedule):
                run(off, width, n_q)
        for si, sh in enumerate(st):
            sh["level0"] = level0[si][:-1].clone()
            sh["upper"] = [u[:-1].clone() for u in upper[si]]

    def _stack_qenc(self, dicts: list[dict], shards: list[Hnsw], n_q: int):
        """Per-shard query-encoding dicts padded to common shapes, each on
        its shard's device. Per-point tensors (leading axis the shard's
        point count) pad rows to ``n_q`` and other axes to the per-key max;
        the other entries are the first shard's, replicated."""
        ref = dicts[0]
        per_point = {
            k for k, v in ref.items()
            if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == shards[0]._n_total
        }
        out = [{} for _ in dicts]
        for k, v0 in ref.items():
            if v0 is None:
                continue
            if k in per_point:
                tgt = (n_q,) + tuple(max(d[k].shape[ax] for d in dicts) for ax in range(1, v0.ndim))
                for si, d in enumerate(dicts):
                    out[si][k] = _pad_to_shape(d[k], tgt, _stack_fill(k)).to(self.mesh.device(si))
            else:
                for si in range(len(dicts)):
                    out[si][k] = v0.to(self.mesh.device(si)) if isinstance(v0, torch.Tensor) else v0
        return out

    @staticmethod
    def _corpus_with_mask(c: dict, pad) -> dict:
        """Shard counts differ, so the count-based row masking of
        ops/graph.py cannot apply across shards: every shard gets an
        explicit row_mask instead."""
        c = dict(c)
        c.pop("count", None)
        c.setdefault("row_mask", pad)
        return {k: v for k, v in c.items() if v is not None}

    def _stack_corpus(self, per_shard_c: list[dict], n_pad: int) -> list[dict]:
        """Per-shard corpus dicts padded to common shapes, each on its
        shard's device. Only keys every shard has survive (one shard's
        vocabulary may exceed the dense gate and lack vocab_mark)."""
        keys = [k for k in per_shard_c[0] if all(k in c for c in per_shard_c)]
        out = [{} for _ in per_shard_c]
        for k in keys:
            # row-indexed tensors pad rows to n_pad; every other axis, and
            # tensors that are not row-indexed (vocab_mark), to the max
            per_row = k != "vocab_mark" and all(c[k].shape[0] == c["vecs"].shape[0] for c in per_shard_c)
            tgt = tuple(max(c[k].shape[ax] for c in per_shard_c) for ax in range(per_shard_c[0][k].ndim))
            if per_row:
                tgt = (n_pad,) + tgt[1:]
            for si, c in enumerate(per_shard_c):
                out[si][k] = _pad_to_shape(c[k], tgt, _stack_fill(k)).to(self.mesh.device(si))
        return out

    def _stack(self, shards: list[Hnsw]) -> None:
        n_pad = max(h.data.ids.shape[0] for h in shards)
        max_lv = max(len(h._upper) for h in shards)
        m = shards[0].maxM
        u_rows = [max((h._upper[l].shape[0] if l < len(h._upper) else 1) for h in shards) for l in range(max_lv)]
        corpora = self._stack_corpus(
            [self._corpus_with_mask(self.space.corpus_dict(h.data), h.data.extra["pad"]) for h in shards], n_pad
        )
        self._shards = []
        for si, h in enumerate(shards):
            dev = self.mesh.device(si)
            ups = []
            for l in range(max_lv):
                u = h._upper[l] if l < len(h._upper) else torch.full((1, m), -1, dtype=torch.int32)
                ups.append(_pad_to_shape(u, (u_rows[l], m), -1).to(dev))
            self._shards.append({
                "corpus": corpora[si],
                "ids": _pad_to_shape(h.data.ids, (n_pad,), -1).to(dev),
                "level0": _pad_to_shape(h.graph["level0"], (n_pad, h.graph["level0"].shape[1]), -1).to(dev),
                "upper": ups,
            })
        # small host-side per-shard state: enough to restore each shard's
        # Hnsw from the stacked graph arrays without rebuilding
        self._shard_meta = [
            {
                "levels": np.asarray(h.levels),
                "order": np.asarray(h.order),
                "meta": np.asarray([h.M, h.maxM, h.maxM0, h.ef_construction, h._entry]),
                "rows": int(h.data.ids.shape[0]),
                "upper_rows": [int(u.shape[0]) for u in h._upper],
            }
            for h in shards
        ]
        self.data = _ShardCorpora(self._shards)  # memory accounting

    # ---------------- diagnostics ----------------

    def check_graph(self) -> list[dict]:
        """Per shard, the self / duplicate / out-of-range link counts of
        Hnsw.check_graph over the shard's real nodes; all zero for a
        healthy graph."""
        out = []
        for sh, meta in zip(self._shards, self._shard_meta):
            n = len(meta["levels"])
            c = {"self_links": 0, "dup_links": 0, "oob_links": 0}
            adjs = [sh["level0"].cpu().numpy()[:n]] + [u.cpu().numpy()[:r] for u, r in
                                                        zip(sh["upper"], meta["upper_rows"])]
            for adj in adjs:
                rows = np.arange(adj.shape[0])[:, None]
                valid = adj >= 0
                c["self_links"] += int(np.sum((adj == rows) & valid))
                c["oob_links"] += int(np.sum(valid & (adj >= n)))
                srt = np.sort(np.where(valid, adj, -np.arange(adj.size).reshape(adj.shape) - 1), axis=1)
                c["dup_links"] += int(np.sum((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)))
            out.append(c)
        return out

    # ---------------- persistence (io/persist.py hooks) ----------------

    def state_arrays(self) -> dict:
        """tpu_knn's keys and shapes: ``mesh_size``, ``level0`` stacked
        [S, n_pad, maxM0], ``upper_{l}`` stacked [S, rows_l, maxM], and per
        shard ``s{si}_levels/_order/_meta/_rows/_upper_rows``."""
        if self._shards is None:
            return {}
        out = {
            "mesh_size": np.asarray([len(self._shard_meta)]),
            "level0": np.stack([sh["level0"].cpu().numpy() for sh in self._shards]),
        }
        for l in range(len(self._shards[0]["upper"])):
            out[f"upper_{l}"] = np.stack([sh["upper"][l].cpu().numpy() for sh in self._shards])
        for si, m in enumerate(self._shard_meta):
            out[f"s{si}_levels"] = m["levels"]
            out[f"s{si}_order"] = m["order"]
            out[f"s{si}_meta"] = m["meta"]
            out[f"s{si}_rows"] = np.asarray([m["rows"]])
            out[f"s{si}_upper_rows"] = np.asarray(m["upper_rows"], np.int64)
        return out

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        if not state:
            self.build(store)
            return
        s = self.mesh.size
        saved = int(np.asarray(state["mesh_size"])[0])
        if saved != s:
            raise InvalidArgumentError(f"sharded index was saved with {saved} shards; current mesh has {s}")
        bounds = self._shard_bounds(len(store), s)
        mat = self._dense_mat(store)
        vf = self._global_vocab_floor(store)
        level0 = np.asarray(state["level0"])
        shards = []
        for si, (lo, hi) in enumerate(bounds):
            h = Hnsw(self.space, Params.of(self.params, seed=self._seed(si)))
            # the graph is built: no sketch proxy; vocab_floor still applies,
            # the shard corpora must have the saved widths
            h.sketch_dim = 0
            h.vocab_floor = vf
            rows = int(np.asarray(state[f"s{si}_rows"])[0])
            sh_state = {
                "level0": level0[si][:rows],
                "levels": state[f"s{si}_levels"],
                "order": state[f"s{si}_order"],
                "meta": state[f"s{si}_meta"],
            }
            for l, ur in enumerate(np.asarray(state[f"s{si}_upper_rows"]).tolist()):
                sh_state[f"upper_{l}"] = np.asarray(state[f"upper_{l}"])[si][: int(ur)]
            h.restore(_subset_store(store, lo, hi, mat), sh_state)
            shards.append(h)
        self._stack(shards)
        self.store = store

    # ---------------- search ----------------

    def set_query_time_params(self, params: Params | None) -> None:
        """As the single-device Hnsw: unknown keys and ef/efSearch
        conflicts raise; None restores the defaults."""
        if params is None:
            self.ef_search = self.DEFAULT_EF_SEARCH
            self.expand = self.DEFAULT_EXPAND
            return
        pm = ParamManager(Params.of(params))
        self.ef_search = pm.get_synonym(["ef", "efSearch"], self.ef_search, int)
        pm.get("algoType", "hybrid", str)  # parity no-op
        if pm.has("searchExpand"):
            self.expand = pm.get("searchExpand", self.expand, int)
        pm.check_unused()

    def knn(self, points, k: int):
        qenc = self.space.encode_queries(points)
        ef = max(self.ef_search, k)
        dks, idss, nds = [], [], []
        for si, sh in enumerate(self._shards):
            qe = qenc_to(qenc, self.mesh.device(si))
            corpus = sh["corpus"]
            b = next(v.shape[0] for v in qe.values() if isinstance(v, torch.Tensor) and v.ndim >= 1)
            cur = torch.zeros(b, dtype=torch.int32, device=sh["ids"].device)
            cur_d = G.score_rows(self.space, qe, corpus, cur[:, None])[:, 0]
            for adj in reversed(sh["upper"]):
                cur, cur_d = G.greedy_descent(self.space, qe, corpus, adj, None, cur, cur_d)
            beam_d, beam_i, nd = G.beam_search(self.space, qe, corpus, sh["level0"], None, cur, ef=ef,
                                               expand=self.expand)
            d, pos = beam_d[:, :k], beam_i[:, :k]
            ids = sh["ids"]
            dks.append(d)
            idss.append(torch.where(pos >= 0, ids[pos.clamp(0, ids.shape[0] - 1)], -1))
            nds.append(nd)
        d, ids = merge_sharded_topk(dks, idss, k, self.mesh.device(0))
        # candidate scorings across all shards (reference query.h:33)
        for nd in nds:
            self._add_dist_comps(nd)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        bad = ~np.isfinite(d) | (d >= RESULT_DIST_CUTOFF)
        return np.where(bad, np.inf, d), np.where(bad, -1, ids)


class _ShardCorpora:
    """The tensors of every shard's corpus (memory accounting)."""

    def __init__(self, shards: list[dict]):
        self._shards = shards

    def tensors(self):
        return [v for sh in self._shards for v in sh["corpus"].values() if isinstance(v, torch.Tensor)]
