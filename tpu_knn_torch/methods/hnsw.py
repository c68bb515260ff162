"""HNSW: hierarchical navigable small-world graph (counterpart of
tpu_knn/methods/hnsw.py).

Reference: include/method/hnsw.h, src/method/hnsw.cc. What is preserved:
the layered structure (geometric level sampling with mult = 1/ln(M),
hnsw.h:478-483), efConstruction-bounded candidate search, the
neighbour-selection heuristic (delaunay_type=2, hnsw.h:129-168),
bidirectional linking with shrink-on-overflow (hnsw.h:258-314), maxM0 = 2M
level-0 capacity, and the ef-bounded best-first query search.

What tpu_knn redesigned, and the port keeps:
  * The graph is the reference's "optimized flat index" made explicit:
    level-0 adjacency i32[N, maxM0], upper levels i32[N_l, maxM].
    Insertion order is sorted by level (descending), so the nodes present
    on level l are exactly internal ids < N_l: no slot maps, and the
    global entry point is internal id 0.
  * Construction is *batched insertion waves*: a whole wave of points runs
    beam search against the frozen pre-wave graph at once, neighbour
    selection is vectorized, and reverse edges are applied with a
    sort/group/scatter pass instead of per-node mutexes. Within-wave
    connectivity is preserved by merging each point's nearest wave-mates
    into its candidate set. From ``buildAlgoAutoN`` rows up (or with
    ``buildAlgo="nndescent"``) level 0 is built by NN-descent instead and
    the upper levels by exact per-level k-NN (ops/nndescent.py).
  * Queries run as one batched beam search (ops/graph.py).

The wave step is eager torch ops on the index's device. Every scatter has
unique targets or writes equal values, and the group reductions are
integer ``amax``: the same seed gives the same graph on a GPU too.

A sparse dot-family or jaccard corpus builds on a dense JL-sketch proxy
by default (``sketchDim`` 1024; spaces/sparse.py SketchProxySpace): the
beams run on the sketches, and with ``exactBase``/``exactPairs`` (on by
default) the candidates' base distances and the selection heuristic's
pair distances are exact in the sparse space. ``exactShrink`` makes the
shrink decisions exact too, ``exactPost`` re-inserts every point with
exact scoring after the build, and ``sketchQuery=1`` keeps the proxy for
queries: a sketch-traversed beam re-ranked exactly. ``sketchDim=0``
builds with exact waves.

Parameter surface matches tpu_knn's (reference: hnsw.cc:185-218,
472-507): every parameter it parses is parsed here with the same name,
default and ValueError, so a header it saved loads. Range search raises,
as in the reference (hnsw.cc:710-715).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core.dataset import DataStore
from ..core.errors import IndexNotBuiltError, SpaceIncompatibleError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import graph as G
from ..ops import topk as T
from ..ops.distance import pair_dot
from ..ops.topk import INF
from ..utils import tracing
from ..utils.logging import log
from ..utils.rng import np_rng
from .base import Method

#: Ramped head-wave schedule (see _run_waves). False restores the
#: fixed-width schedule for order-sensitivity studies.
WAVE_RAMP = True


def _corpus_dict(space, data) -> dict:
    """Row-indexed corpus tensors for gather-based search (delegates to the
    space so other layouts provide their own keys)."""
    return space.corpus_dict(data)


def _gather_qenc(qenc_all: dict, ids, n_total: int) -> dict:
    """Gather per-node query encodings at arbitrary node-id tensors."""
    out = {}
    for k, v in qenc_all.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n_total:
            out[k] = v[ids]
        else:
            out[k] = v
    return out


def _score_pairs(space, qenc_all, n_total, corpus, ids_a, ids_b):
    """d(a_i, b_j) for per-row candidate sets: ids_a [B, C], ids_b [B, C2]
    -> [B, C, C2]. Uses each candidate's own query encoding against
    gathered corpus rows, so it is valid for every space (asymmetric
    divergences included): the space's ``pair_block`` where it has one
    (the sparse, string, SQFD and fusion spaces; the elementwise kernel's
    batched epilogue for the dense spaces with an elementwise form), one
    batched product (ops/distance.pair_dot) for an affine-factored space,
    else ``space.block`` per row, vmapped in row blocks
    (ops/graph.vmap_blocks; tpu_knn's lax.map of 512-row blocks)."""
    rows, pad, extra = G.gather_rows(corpus, ids_b)  # [B, C2, D]
    extra = G.inject_term(space, rows, extra)
    qe = _gather_qenc(qenc_all, ids_a.clamp(0, n_total - 1), n_total)
    aff = space.pass1_affine() if hasattr(space, "pass1_affine") else None
    pb = getattr(space, "pair_block", None)
    if pb is not None:  # the space's own pair scorer
        vm = corpus.get("vocab_mark")
        d = pb(qe, rows, pad, extra, None if vm is None else vm.shape[0])
    elif aff is not None and rows.ndim == 3:
        scale, sq, sx = aff
        s = scale * pair_dot(qe["q"], rows)
        if sq != 0.0 and "q_term" in qe:
            s = s + sq * qe["q_term"][:, :, None]
        if sx != 0.0 and "x_term" in extra:
            s = s + sx * extra["x_term"][:, None, :]
        d = space.pass1_post(s, qe) + pad[:, None, :]
    else:
        b = ids_a.shape[0]
        axes = G.qenc_axes(qe, b, ndim=2)

        def one(qe_row, r, p, ex):
            return space.block(qe_row, {"x": r, "pad": p, **ex})  # [C, C2]

        d = G.vmap_blocks(one, qe, axes, (rows, pad, extra), ids_a.shape[1] * rows[0].numel())
    return torch.where(ids_a[:, :, None] < 0, INF, d)


def make_wave_step(
    space,
    n_total: int,
    w: int,
    max_level: int,
    *,
    efc: int,
    m: int,
    m0cap: int,
    mcap: int,
    mates: int,
    expand: int,
    selection: str,  # "none" (delaunay_type=0: keep closest), "heur", "rng"
    exact_space=None,
    exact_pairs: bool = False,
    exact_base: bool = True,
    exact_shrink: bool = False,
    use_cstore: bool = False,
    merge_forward: bool = False,
):
    """Build the batched insertion wave step.

    The step updates the adjacency tensors it is given IN PLACE. Each
    carries one spare last row: a scatter whose target tpu_knn drops
    (``.at[oob].set(..., mode="drop")``) writes there instead, so no
    data-dependent shape and no device-to-host sync is needed. The beams
    see the tensors without that row.

    ``use_cstore``: maintain an int8 replicated-neighbour store aligned to
    the LEVEL-0 adjacency across waves and ride the level-0 construction
    beam on it (the query-time nbr_store applied at build time): the
    beam's candidate row gathers (w*expand*m0cap rows per iteration)
    become w*expand contiguous block reads. Each wave rewrites only the
    store rows its level-0 scatters touched (wave rows + reverse targets,
    ~w*(M+1) blocks). Selection stays exact: the beam's ef candidates are
    re-scored from the corpus rows before the heuristic, so quantization
    only perturbs which candidates the beam EXPLORES.

    ``exact_space`` (a sketch-proxy build, with the step's ``ecorpus`` and
    ``eqenc_all`` of the sparse space): ``exact_base`` re-scores the beam's
    candidates exactly before selection, ``exact_pairs`` scores the
    selection heuristic's pairs exactly, ``exact_shrink`` the merge and
    reverse shrinks. The beams stay on the proxy.

    The step's phases are traced as ``hnsw.wave.<phase>`` spans
    (utils/tracing.py): ``beam``, ``mates``, ``pairs``, ``select``,
    ``forward``, ``reverse`` (``pairs`` and ``select`` also run inside
    ``reverse``) and ``cstore``.
    """
    big = 2**30  # sort key of an invalid (neighbour, wave point) pair

    def wave_step(level0, upper, start: int, wl, entry: int, limit: int, corpus, qenc_all,
                  cstore=None, xq=None, xscale=None, ecorpus=None, eqenc_all=None):
        """Insert/refresh points [start, start+w). ``limit`` bounds which
        graph nodes may be linked to: ``start`` during the initial build
        (frozen prefix), ``n`` during post passes (full visibility;
        reference: hnsw.cc:251-338)."""
        dev = level0.device
        exact = exact_space is not None and ecorpus is not None

        def exact_qenc(ids):
            return G.densify_queries(exact_space, _gather_qenc(eqenc_all, ids, n_total), ecorpus)

        def span(key):
            return tracing.span("hnsw.wave." + key, timed=True)

        def level_candidates(adj, l, cur):
            """Beam over the frozen graph + nearest wave-mates, heuristic-
            selected down to M forward neighbours. Returns (sel [W,M],
            best_d [W], best_i [W]) where best_* trace the closest frozen
            point seen (for entry hand-off to the next level)."""
            nbr_store = (cstore[:-1], xscale) if (use_cstore and l == 0) else None
            with span("beam"):
                beam_d, beam_i, _ = G.beam_search(
                    space, qe, corpus, adj[:-1], None, cur, ef=efc, expand=expand,
                    nbr_store=nbr_store,
                )
            with span("mates"):
                frozen_ok = (beam_i < limit) & (beam_i >= 0) & (beam_i != wave_ids[:, None])
                beam_i = torch.where(frozen_ok, beam_i, -1)
                beam_d = torch.where(frozen_ok, beam_d, INF)

                # the mate row set is the SAME [w] rows for every wave point:
                # one [w, D] gather + one [w, w] block, not a w*w*D gather
                rows1, pad1, extras1 = G.gather_rows(corpus, wave_ids[None, :])
                extras1 = G.inject_term(space, rows1, extras1)
                xc_wave = {"x": rows1[0], "pad": pad1[0]}
                xc_wave.update({kk: vv[0] for kk, vv in extras1.items()})
                if "vocab_mark" in corpus:  # the sparse table's width carrier
                    xc_wave["vocab_mark"] = corpus["vocab_mark"]
                mate_d = space.block(qe, xc_wave)  # [w, w]
                bad = (wave_ids[None, :] == wave_ids[:, None]) | (wl[None, :] < l) | (wl[None, :] < 0)
                mate_d = torch.where(bad, INF, mate_d)
                mate_dd, mpos = T.smallest_k(mate_d, mates)
                mate_ok = mate_dd < INF
                mate_sel = torch.where(mate_ok, wave_ids[mpos], -1)
                mate_dd = torch.where(mate_ok, mate_dd, INF)
                dup = (mate_sel[:, :, None] == beam_i[:, None, :]).any(dim=2)
                mate_sel = torch.where(dup, -1, mate_sel)
                mate_dd = torch.where(dup, INF, mate_dd)

                cand_i = torch.cat([beam_i, mate_sel], dim=1)
                cand_d = torch.cat([beam_d, mate_dd], dim=1)
                if exact_base and exact:
                    # hybrid refinement of a sketch-proxy build: the beam
                    # found the candidates on proxy scores; their base
                    # distances are exact in the sparse space, so selection
                    # ranks true neighbours first (first sorted by the
                    # proxy, as tpu_knn does, for the order of exact ties)
                    cand_d, o = torch.sort(cand_d, dim=1, stable=True)
                    cand_i = torch.gather(cand_i, 1, o)
                    cand_d = G.score_rows(exact_space, eqe_wave, ecorpus, cand_i)
                elif use_cstore and l == 0:
                    # the beam ranked candidates by dequantized-int8 store
                    # scores; re-score them from the corpus rows so the
                    # selection heuristic (and the stored edge distances the
                    # reverse shrink competes on) stay exact. tpu_knn sorts
                    # by the store's scores first: a stable sort, so the
                    # order of exactly tied candidates comes from it.
                    cand_d, o = torch.sort(cand_d, dim=1, stable=True)
                    cand_i = torch.gather(cand_i, 1, o)
                    cand_d = G.score_rows(space, qe, corpus, cand_i)
                cand_d, o = torch.sort(cand_d, dim=1, stable=True)
                cand_i = torch.gather(cand_i, 1, o)
            if selection == "none":
                # delaunay_type=0 (reference hnsw.cc:581-586): keep the M
                # closest candidates, no pruning and no pair scoring
                valid = cand_d < INF
                keep = valid & (torch.cumsum(valid, dim=1) <= m)
            else:
                with span("pairs"):
                    if exact_pairs and exact:
                        # exact pair distances: on near-tied data proxy pair
                        # scores make the prune decisions noise
                        pair_d = _score_pairs(exact_space, eqenc_all, n_total, ecorpus, cand_i, cand_i)
                    else:
                        pair_d = _score_pairs(space, qenc_all, n_total, corpus, cand_i, cand_i)
                with span("select"):
                    keep = G.select_neighbors_heuristic(cand_d, pair_d, m, exact=selection != "rng")
            sel = G.pack_selected(cand_i, keep, m)
            connect = (wl >= l) & (wl >= 0)
            sel = torch.where(connect[:, None], sel, -1)
            # entry hand-off for the next level: the closest FROZEN beam
            # node only (the reference descends through inserted nodes,
            # hnsw.cc:593-599). A wave-mate may score closer, but its
            # lower-level adjacency rows are not scattered yet: handing off
            # to it would strand the next level's beam on an empty row.
            # beam_d/beam_i are already frozen-masked (INF/-1) above.
            bpos = torch.argmin(beam_d, dim=1, keepdim=True)
            best_d = torch.gather(beam_d, 1, bpos)[:, 0]
            best_i = torch.gather(beam_i, 1, bpos)[:, 0]
            return sel, best_d, best_i

        def shrink_or_append(old, new_c, cand, base_d, cap):
            """A row's old links plus its inserts ``new_c``: appended when
            they fit, else shrunk to ``cap`` by the heuristic over all of
            them (delaunay_type=0: the cap closest, reference
            hnsw.h:301-312); with ``exact_shrink`` its pairs are exact."""
            overflow = (old >= 0).sum(dim=1) + (new_c >= 0).sum(dim=1) > cap
            # append path: valid entries first, order preserved
            appended = G.pack_selected(cand, cand >= 0, cap)
            sd, o = torch.sort(base_d, dim=1, stable=True)
            si = torch.gather(cand, 1, o)
            if selection == "none":
                validr = sd < INF
                keep = validr & (torch.cumsum(validr, dim=1) <= cap)
            else:
                with span("pairs"):
                    if exact_shrink and exact:
                        pair_d = _score_pairs(exact_space, eqenc_all, n_total, ecorpus, si, si)
                    else:
                        pair_d = _score_pairs(space, qenc_all, n_total, corpus, si, si)
                with span("select"):
                    keep = G.select_neighbors_heuristic(sd, pair_d, cap, exact=selection != "rng")
            shrunk = G.pack_selected(si, keep, cap)
            return torch.where(overflow[:, None], shrunk, appended)

        def scatter_forward(adj, cap, sel, connect):
            spare = adj.shape[0] - 1
            tgt = torch.where(connect, wave_ids, spare)
            if not merge_forward:
                if cap > m:
                    fwd = torch.cat([sel, sel.new_full((w, cap - m), -1)], dim=1)
                else:
                    fwd = sel[:, :cap]
                adj[tgt] = fwd
                return
            # post-pass merge: REPLACING the row with the fresh selection
            # would wipe the reverse edges the row accumulated. Merge
            # old U sel and shrink to cap with the same heuristic the
            # reverse path uses.
            old = adj[wave_ids.clamp(0, spare - 1)]  # [w, cap]
            dup = (sel[:, :, None] == old[:, None, :]).any(dim=2)
            selx = torch.where(dup, -1, sel)
            cand = torch.cat([old, selx], dim=1)  # [w, cap+m]
            cand = torch.where(cand == wave_ids[:, None], -1, cand)
            if exact_shrink and exact:
                base_d = G.score_rows(exact_space, eqe_wave, ecorpus, cand)
            else:
                base_d = G.score_rows(space, qe, corpus, cand)
            adj[tgt] = shrink_or_append(old, selx, cand, base_d, cap)

        def reverse_update(adj, cap, sel, connect):
            """Insert each wave node into its selected neighbours' rows;
            overflowing rows are shrunk with the heuristic (reference:
            hnsw.h:258-314 link + addFriendlevel shrink)."""
            spare = adj.shape[0] - 1
            p_ids = wave_ids[:, None].expand(sel.shape).reshape(-1)
            n_ids = sel.reshape(-1)
            valid = (n_ids >= 0) & connect[:, None].expand(sel.shape).reshape(-1)
            npairs = n_ids.shape[0]
            # group the pairs by neighbour: a stable sort, so within a group
            # the wave points keep ascending order
            sn, order = torch.sort(torch.where(valid, n_ids, big), stable=True)
            sp, sv = p_ids[order], valid[order]
            first = torch.cat([sn.new_ones(1, dtype=torch.bool), sn[1:] != sn[:-1]]) & sv
            gid = (torch.cumsum(first, dim=0) - 1).clamp(0, npairs - 1)  # group index (valid rows only)
            iar = torch.arange(npairs, dtype=torch.int32, device=dev)
            # integer amax: exact in any order
            gstart = torch.zeros(npairs, dtype=torch.int32, device=dev).scatter_reduce_(
                0, gid, torch.where(first, iar, 0), "amax")
            pos = iar - gstart[gid]
            gcap = mates  # insertion cap per neighbour per wave
            okslot = sv & (pos < gcap)
            # (group, slot) is unique among the kept pairs; the others all
            # write -1 into the spare row
            new_c = sel.new_full((npairs + 1, gcap), -1)
            new_c[torch.where(okslot, gid, npairs), pos.clamp(0, gcap - 1).long()] = torch.where(okslot, sp, -1)
            new_c = new_c[:npairs]
            grp_n = sel.new_full((npairs,), -1).scatter_reduce_(0, gid, torch.where(first, sn, -1), "amax")
            grp_valid = grp_n >= 0
            base = torch.where(grp_valid, grp_n, 0)

            old = adj[base]  # [P, cap]
            # drop inserts already present in the row (post passes re-insert)
            dup_old = (new_c[:, :, None] == old[:, None, :]).any(dim=2)
            new_c = torch.where(dup_old, -1, new_c)
            cand = torch.cat([old, new_c], dim=1)  # [P, cap+gcap]
            if exact_shrink and exact:
                base_d = G.score_rows(exact_space, exact_qenc(base), ecorpus, cand)
            else:
                base_d = G.score_rows(space, _gather_qenc(qenc_all, base, n_total), corpus, cand)
            newrow = shrink_or_append(old, new_c, cand, base_d, cap)
            # one target per valid group; the others land in the spare row
            adj[torch.where(grp_valid, base, spare)] = newrow

        wave_ids = start + torch.arange(w, dtype=torch.int32, device=dev)
        # a last wave may reach past the corpus: those points take the last
        # row's encoding (a clamped gather) and are masked by wl < 0
        safe_ids = wave_ids.clamp(max=n_total - 1)
        qe = G.densify_queries(space, _gather_qenc(qenc_all, safe_ids, n_total), corpus)
        eqe_wave = exact_qenc(safe_ids) if exact else None
        cur = torch.full((w,), entry, dtype=torch.int32, device=dev)  # global entry point
        cur_d = G.score_rows(space, qe, corpus, cur[:, None])[:, 0]
        for l in range(max_level, 0, -1):
            adj = upper[l - 1]
            connect = (wl >= l) & (wl >= 0)
            sel, best_d, best_i = level_candidates(adj, l, cur)
            with span("forward"):
                scatter_forward(adj, mcap, sel, connect)
            with span("reverse"):
                reverse_update(adj, mcap, sel, connect)
            better = (best_i >= 0) & (best_d < cur_d)
            cur = torch.where(better, best_i, cur)
            cur_d = torch.where(better, best_d, cur_d)
        connect0 = wl >= 0
        sel, _, _ = level_candidates(level0, 0, cur)
        with span("forward"):
            scatter_forward(level0, m0cap, sel, connect0)
        with span("reverse"):
            reverse_update(level0, m0cap, sel, connect0)
        if use_cstore:
            # refresh the store rows this wave's level-0 scatters touched:
            # the wave rows themselves (scatter_forward) and every
            # forward-selected target (reverse_update rewrites exactly the
            # rows grouped from sel). Duplicate ids in `ch` all write the
            # value derived from the same post-update level0 row, so the
            # unordered scatter is deterministic. ~w*(M+1) blocks per wave.
            with span("cstore"):
                spare = level0.shape[0] - 1
                ch = torch.cat([
                    torch.where(connect0, wave_ids, spare),
                    torch.where(sel >= 0, sel, spare).reshape(-1),
                ])
                rows_ids = level0[ch]
                cstore[ch] = xq[rows_ids.clamp(0, xq.shape[0] - 1)]

    return wave_step


def _search_core(space, qenc, data, level0, upper, entry: int, ef: int, k: int, expand: int,
                 nbr_store=None):
    corpus = _corpus_dict(space, data)
    qenc = G.densify_queries(space, qenc, corpus)
    b = next(v.shape[0] for v in qenc.values() if getattr(v, "ndim", 0) >= 1)
    cur = torch.full((b,), entry, dtype=torch.int32, device=level0.device)
    cur_d = G.score_rows(space, qenc, corpus, cur[:, None])[:, 0]
    for adj in reversed(upper):
        cur, cur_d = G.greedy_descent(space, qenc, corpus, adj, None, cur, cur_d)
    beam_d, beam_i, nd = G.beam_search(
        space, qenc, corpus, level0, None, cur, ef=ef, expand=expand, nbr_store=nbr_store,
    )
    if nbr_store is not None:
        # beam ordering used the store's rounded rows; re-score a top slice
        # exactly and re-sort so reported distances/ids are exact
        kk = min(ef, k + 6)
        sl_i = beam_i[:, :kk]
        sl_d = G.score_rows(space, qenc, corpus, sl_i)
        sl_d = torch.where(sl_i < 0, INF, sl_d)
        d, sel = T.smallest_k(sl_d, k)
        pos = torch.gather(sl_i, 1, sel)
        pos = torch.where(torch.isinf(d), -1, pos)
    else:
        d, pos = beam_d[:, :k], beam_i[:, :k]
    ids = torch.where(pos >= 0, data.ids[pos.clamp(0, data.ids.shape[0] - 1)], -1)
    return d, ids, nd


def _search_sketch(pspace, rspace, qenc_p, qenc_r, pdata, rdata, level0, upper, entry: int, ef: int, k: int,
                   expand: int):
    """Beam search on the dense sketch proxy, then an exact re-rank of the
    whole beam in the sparse space: the proxy only steers traversal, the
    reported distances and ids are exact."""
    pcorpus = pspace.corpus_dict(pdata)
    b = qenc_p["q"].shape[0]
    cur = torch.full((b,), entry, dtype=torch.int32, device=level0.device)
    cur_d = G.score_rows(pspace, qenc_p, pcorpus, cur[:, None])[:, 0]
    for adj in reversed(upper):
        cur, cur_d = G.greedy_descent(pspace, qenc_p, pcorpus, adj, None, cur, cur_d)
    _, beam_i, nd = G.beam_search(pspace, qenc_p, pcorpus, level0, None, cur, ef=ef, expand=expand)
    ex_d = G.score_rows(rspace, qenc_r, rspace.corpus_dict(rdata), beam_i)  # exact [B, ef]
    d, sel = T.smallest_k(ex_d, k)
    pos = torch.gather(beam_i, 1, sel)
    pos = torch.where(d >= INF, -1, pos)
    ids = torch.where(pos >= 0, rdata.ids[pos.clamp(0, rdata.ids.shape[0] - 1)], -1)
    return d, ids, nd + (beam_i >= 0).sum()


@register_method("hnsw")
class Hnsw(Method):
    name = "hnsw"
    supports_range = False

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        self.M = pm.get("M", 16, int)
        self.maxM = pm.get("maxM", self.M, int)
        self.maxM0 = pm.get("maxM0", 2 * self.M, int)
        self.ef_construction = pm.get("efConstruction", 200, int)
        self.mult = pm.get("mult", 1.0 / math.log(max(self.M, 2)), float)
        self.delaunay_type = pm.get("delaunay_type", 2, int)
        self.post = pm.get("post", 0, int)
        pm.get("indexThreadQty", 0, int)  # parity no-op: waves batch instead
        pm.get("skip_optimized_index", 0, int)  # flat layout is the only layout
        self.wave = pm.get("waveSize", 256, int)
        self.wave_mates = pm.get("waveMates", 8, int)
        self.expand = pm.get("searchExpand", 4, int)
        self._expand_default = self.expand  # restored by reset (None) below
        self.construction_expand = pm.get("constructionExpand", 4, int)
        # Construction algorithm: "waves" = batched insertion waves
        # (reference-faithful incremental semantics), "nndescent" =
        # whole-corpus NN-descent refinement (ops/nndescent.py), "auto" =
        # NN-descent at or above buildAlgoAutoN rows, waves below.
        self.build_algo = pm.get("buildAlgo", "auto", str)
        if self.build_algo not in ("auto", "waves", "nndescent"):
            raise ValueError(f"bad buildAlgo {self.build_algo!r}")
        self.build_algo_auto_n = pm.get("buildAlgoAutoN", 300_000, int)
        # NN-descent knobs (ops/nndescent.py)
        self.nnd_k = pm.get("nndK", 48, int)
        self.nnd_krev = pm.get("nndKrev", 16, int)
        self.nnd_t = pm.get("nndT", 8, int)
        self.nnd_iters = pm.get("nndIters", 10, int)
        self.nnd_chunk = pm.get("nndChunk", 512, int)
        self.nnd_level_k = pm.get("nndLevelK", 64, int)
        self.nnd_store = pm.get("nndStoreDtype", "int8", str)
        if self.nnd_store not in ("int8", "float32"):
            raise ValueError(f"bad nndStoreDtype {self.nnd_store!r}")
        self.nnd_fill = pm.get("nndFillPruned", 1, int)
        self.nnd_random = pm.get("nndRandom", 8, int)
        self.nnd_rev = pm.get("nndRevMode", "shrink", str)
        if self.nnd_rev not in ("shrink", "slots"):
            raise ValueError(f"bad nndRevMode {self.nnd_rev!r}")
        self.nnd_polish = pm.get("nndPolish", 1, int)
        self.nnd_polish_store = pm.get("nndPolishStore", 1, int)
        self.nnd_profile = pm.get("nndProfile", 0, int)
        # DiskANN-style neighbourhood replication: store each node's
        # neighbours' vectors contiguously so one beam expansion reads one
        # contiguous block instead of maxM0 rows. Costs n*maxM0*d
        # bytes/elem of device memory; opt-in. The final top-k is re-scored
        # exactly either way.
        self.replicate_neighbors = pm.get("replicateNeighbors", 0, int)
        # JL-sketch width of the sparse construction proxy (0: exact waves);
        # consulted only when the space provides sketch_proxy
        self.sketch_dim = pm.get("sketchDim", 1024, int)
        # sketch-scored query traversal + exact re-rank of the beam
        self.sketch_query = pm.get("sketchQuery", 0, int)
        # hybrid construction: exact base distances of the candidates and
        # exact pair distances in the selection heuristic
        self.exact_base = pm.get("exactBase", 1, int)
        self.exact_pairs = pm.get("exactPairs", 1, int)
        # exact-space post passes after a proxy build, and exact shrinks
        self.exact_post = pm.get("exactPost", 0, int)
        self.exact_shrink = pm.get("exactShrink", 0, int)
        self.nbr_store_dtype = pm.get("nbrStoreDtype", "bfloat16", str)
        if self.nbr_store_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"bad nbrStoreDtype {self.nbr_store_dtype!r}")
        # construction-time replicated neighbour store (int8, level 0): see
        # make_wave_step(use_cstore=...). Default ON where eligible
        # (_cstore_ok: dense f32/bf16 rows); selection re-scores candidates
        # from the corpus rows, so int8 only perturbs beam exploration. Set
        # constructionStore=0 to disable.
        self._cstore_explicit = pm.has("constructionStore")
        self.construction_store = pm.get("constructionStore", 1, int)
        self.seed = pm.get("seed", 0, int)
        pm.check_unused()
        self._nbr_store = None
        self._proxy = None  # (SketchProxySpace, DenseDeviceData, R) or None
        # query-time defaults (reference: ef/efSearch default 20, hnsw.cc:483)
        self.ef_search = 20
        self._entry = 0  # global entry point (internal id)
        self.graph = None
        self._upper: list = []
        self.levels = None
        self.order = None
        self._qenc_all = None
        self._exact_qenc_all = None  # sparse-space encodings of a proxy build

    # ---------------- query-time params ----------------

    #: method default efSearch (reference: ef/efSearch default 20, hnsw.cc:483)
    DEFAULT_EF_SEARCH = 20

    def set_query_time_params(self, params: Params | None) -> None:
        if params is None:
            # ResetQueryTimeParams semantics (reference: index.h / hnsw.cc):
            # restore method defaults instead of keeping previous values
            self.ef_search = self.DEFAULT_EF_SEARCH
            self.expand = self._expand_default
            super().set_query_time_params(None)
            return
        pm = ParamManager(Params.of(params))
        self.ef_search = pm.get_synonym(["ef", "efSearch"], self.ef_search, int)
        pm.get("algoType", "hybrid", str)  # parity no-op: single search algo
        if pm.has("searchExpand"):
            self.expand = pm.get("searchExpand", self.expand, int)
        pm.check_unused()
        super().set_query_time_params(params)

    def _effective_expand(self, ef: int) -> int:
        """Fixed expansion width; searchExpand is the manual override."""
        return self.expand

    # ---------------- construction ----------------

    def _sample_levels(self, n: int, rng) -> np.ndarray:
        """Geometric level sampling (reference: hnsw.h:478-483)."""
        u = rng.random(max(n, 1))
        return np.minimum(
            np.floor(-np.log(np.maximum(u, 1e-12)) * self.mult), 32
        ).astype(np.int32)[:n]

    #: SwGraph keeps the wave encodings after the build: its delete path
    #: re-scores pairs with them. Plain HNSW is immutable once built, so
    #: construction-only state is dropped.
    KEEP_WAVE_STATE = False

    #: a host f32[V_pad, dskp] matrix that replaces the drawn sketch R
    #: (spaces/sparse.py sketch_proxy's r_mat): a test hook
    sketch_r = None

    #: shard hooks of parallel/hnsw_sharded.py: a sparse corpus encodes to
    #: at least this vocabulary width (0: its own), and the JL sketch draws
    #: R from this seed (None: the build's ``seed``), so every shard of a
    #: sharded build shares one proxy space
    vocab_floor = 0
    sketch_seed = None

    def _resolve_build_algo(self, n: int) -> str:
        """buildAlgo with "auto" resolved: NN-descent from buildAlgoAutoN
        rows up; sketch-proxy builds stay on waves, as in tpu_knn."""
        algo = self.build_algo
        if algo == "auto":
            algo = "nndescent" if n >= self.build_algo_auto_n and self._proxy is None else "waves"
        return algo

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        n = self._prepare(store)
        if n == 0:
            return
        algo = self._resolve_build_algo(n)
        if not (algo == "nndescent" and self._build_nndescent(n)):
            if algo == "nndescent" and self.build_algo == "nndescent":
                log("WARNING", "hnsw: buildAlgo=nndescent needs a symmetric affine row encode; falling back to waves")
            self._run_waves(0, n)
        self._drop_wave_state()
        log("DEBUG", f"{self.name} built: n={n} max_level={self._max_level}")

    # ----- NN-descent construction (ops/nndescent.py) -----

    def _will_use_nnd(self, n: int) -> bool:
        """The buildAlgo routing of create_index, resolved before encoding
        so _encode_store can skip the construction encodings an NN-descent
        build never reads. Methods that keep wave state for post-build
        maintenance still need them."""
        if self.KEEP_WAVE_STATE:
            return False
        return self._resolve_build_algo(n) == "nndescent" and self._nnd_eligible()

    def _nnd_eligible(self) -> bool:
        """NN-descent scores both sides from corpus rows: it needs the
        affine pass-1 form, corpus rows that are their own query encodings
        and a plain dense row layout."""
        sp = self._graph_space
        aff = getattr(sp, "pass1_affine", None)
        if aff is None or aff() is None:
            return False
        raq = getattr(sp, "rows_as_queries", None)
        if raq is None:
            return False
        corpus = _corpus_dict(sp, self._graph_data)
        vecs = corpus.get("vecs")
        if getattr(vecs, "ndim", 0) != 2 or "row_mask" in corpus or "term" in corpus:
            return False
        return raq(vecs[:1]) is not None

    def _build_nndescent(self, n: int) -> bool:
        """Level 0 by NN-descent + heuristic prune + reverse links; upper
        levels by exact per-level k-NN (each level is a prefix of the
        level-sorted order). Replaces the insertion waves wholesale;
        ``post`` passes do not apply. Returns False where the space is not
        eligible."""
        if not self._nnd_eligible():
            return False
        from ..ops import nndescent as ND

        sp = self._graph_space
        corpus = _corpus_dict(sp, self._graph_data)
        dev = corpus["vecs"].device
        # both sides are scored from corpus rows: the encoded-corpus copy of
        # the waves is dead weight (unless kept for post-build maintenance)
        if not self.KEEP_WAVE_STATE:
            self._qenc_all = None
        selection = "none" if self.delaunay_type == 0 else "heur"
        prof = bool(self.nnd_profile)
        _pt = [time.perf_counter()]

        def mark(name):
            """Drain the device and log the phase's wall (nndProfile=1 only)."""
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            log("INFO", f"hnsw nnd phase {name}: {now - _pt[0]:.3f}s")
            _pt[0] = now

        prog = (
            (lambda it, ch: log("INFO", f"hnsw nnd sweep {it + 1}: {ch} updates"))
            if (getattr(self, "progress", False) or prof) else None
        )
        dist, adj = ND.build_knn_graph(
            sp, corpus, n,
            k=self.nnd_k, iters=self.nnd_iters, krev=self.nnd_krev, t_keep=self.nnd_t, chunk=self.nnd_chunk,
            seed=self.seed, store_dtype=self.nnd_store, n_random=self.nnd_random,
            progress=prog, mark=mark if prof else None,
        )
        n_pad = self.data.ids.shape[0]

        def link():
            """k-NN lists -> level-0 adjacency (+ reachability repair)."""
            lv0 = ND.prune_and_link(
                sp, corpus, dist, adj, n, m=self.M, cap=self.maxM0, chunk=self.nnd_chunk, selection=selection,
                fill=bool(self.nnd_fill), rev_mode=self.nnd_rev, mark=mark if prof else None,
            )[:n_pad]
            # a refinement-built graph has no insertion-time reachability
            # guarantee: link stranded components back to the entry's
            lv0, fixed = ND.repair_reachability(sp, corpus, lv0, n, entry=self._entry)
            if fixed:
                log("INFO", f"hnsw nnd: repaired reachability of {fixed} nodes")
            return lv0

        level0 = link()
        if prof:
            mark("link0")
        new_upper = []
        for lv in range(1, self._max_level + 1):
            n_l = self._upper[lv - 1].shape[0]
            new_upper.append(ND.build_level_exact(
                sp, corpus, n_l, m=self.M, cap=self.maxM, k_cand=min(self.nnd_level_k, max(n_l - 1, 1)),
                chunk=min(2048, max(n_l, 1)), selection=selection, fill=bool(self.nnd_fill),
                n_random=self.nnd_random, seed=self.seed, rev_mode=self.nnd_rev,
            ))
        self._upper = new_upper
        if prof and new_upper:
            mark("uppers")
        # beam-polish passes: batched re-insertion of every node through the
        # built graph, whose beam paths restore the mid-range edges the k-NN +
        # uniform-random candidate pool lacks (ops/nndescent._polish_chunk_math)
        polish_store = bool(self.nnd_polish_store) and self._cstore_ok()

        def polish_prog(ci, nc, state):
            # profile mode: a line every 64 chunks, the device drained first
            if ci % 64 == 63:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                log("INFO", f"hnsw nnd polish chunk {ci + 1}/{nc}")

        for p in range(self.nnd_polish):
            dist, adj = ND.polish_knn_lists(
                sp, corpus, level0, self._upper, dist, adj, n, efc=self.ef_construction,
                expand=self.construction_expand, entry=self._entry,
                # tpu_knn's chunk: a batched beam runs while any of its queries
                # is active, so the chunk size shapes the graph
                chunk=min(2048, self.nnd_chunk * 2),
                use_store=polish_store, progress=polish_prog if prof else None,
            )
            if prof:
                mark(f"polish{p}")
            level0 = link()
            if prof:
                mark(f"link{p + 1}")
        self.graph = {"level0": level0}
        return True

    def _drop_wave_state(self) -> None:
        """Free construction-only device state: the corpus-as-queries
        encodings (a second full copy of the corpus) and, unless
        sketchQuery traverses it, the sketch proxy. Queries run on
        self.space/self.data."""
        if self.KEEP_WAVE_STATE:
            return
        self._qenc_all = None
        self._exact_qenc_all = None
        if not self.sketch_query:
            self._proxy = None
            self._graph_space, self._graph_data = self.space, self.data

    def _prepare(self, store: DataStore) -> int:
        """Everything before the insertion waves: level sampling, level-
        descending reorder, corpus/query encoding, empty graph allocation.
        Returns the point count (0 = nothing to insert)."""
        self.store = store
        n = len(store)
        rng = np_rng(self.seed)
        levels = self._sample_levels(n, rng)
        order = np.argsort(-levels, kind="stable")
        self.order = order
        self.levels = levels[order]
        self._encode_store(store, n)
        if n == 0:
            return 0
        max_level = int(self.levels.max(initial=0))
        self._max_level = max_level
        n_pad = self.data.ids.shape[0]
        dev = self.data.ids.device
        self.graph = {"level0": torch.full((n_pad, self.maxM0), -1, dtype=torch.int32, device=dev)}
        self._upper = [
            torch.full((max(int(np.sum(self.levels >= l)), 1), self.maxM), -1, dtype=torch.int32, device=dev)
            for l in range(1, max_level + 1)
        ]
        return n

    def _encode_store(self, store: DataStore, n: int, skip_construction: bool = False) -> None:
        """Encode + level-sorted reorder of the corpus, and all corpus
        points as query encodings (used to score point-point pairs during
        construction).

        A sparse dot-family or jaccard space with sketchDim > 0 also gets
        its JL-sketch proxy (spaces/sparse.py): the graph is built on the
        proxy's dense rows, and the sparse space's own encodings are kept
        for the exact refinements (exactBase, exactPairs, exactPost,
        exactShrink)."""
        if self.vocab_floor:
            self.data = self.space.encode_dataset(store, row_multiple=8, vocab_floor=self.vocab_floor)
        else:
            self.data = self.space.encode_dataset(store, row_multiple=8)
        self._proxy = None
        self._exact_qenc_all = None
        n_pad = self.data.ids.shape[0]
        # index-time scoring may differ from query-time scoring; for every
        # ported space construction_space() is the space itself
        self._graph_space = self.space.construction_space()
        if n == 0:
            self.graph = {
                "level0": torch.full((n_pad, self.maxM0), -1, dtype=torch.int32, device=self.data.ids.device)
            }
            self._upper = []
            self._graph_data = self.data
            return
        self.data = self._reorder_data(self.data, self.order, n)
        self._graph_data = self.data
        mk = getattr(self.space, "sketch_proxy", None)
        if mk is not None and self.sketch_dim > 0:
            sseed = self.seed if self.sketch_seed is None else self.sketch_seed
            self._proxy = mk(self.data, self.sketch_dim, sseed, r_mat=self.sketch_r)
        points = lambda: self.space.store_as_query_points(store)[self.order]  # noqa: E731
        if self._proxy is not None:
            pspace, pdata, _ = self._proxy
            self._graph_space, self._graph_data = pspace, pdata
            # corpus points as construction queries ARE the sketches
            self._qenc_all = None if skip_construction else {"q": pdata.vecs[:n]}
            if not skip_construction and (self.exact_base or self.exact_pairs or self.exact_post
                                          or self.exact_shrink):
                self._exact_qenc_all = self.space.encode_queries(points())
        else:
            # a restore with the graph already built never runs waves, and
            # an NN-descent build scores both sides from corpus rows: skip
            # encoding a second full corpus copy they would drop
            self._qenc_all = (
                None if skip_construction or self._will_use_nnd(n) else self.space.encode_queries(points())
            )
        # row count of the per-node query encodings (unpadded)
        self._n_total = n

    def _run_waves(self, lo: int, hi: int) -> None:
        """Insert points [lo, hi) in batched waves against the frozen
        prefix graph (the wave step only links to ids < wave start)."""
        n = hi - lo
        if n <= 0:
            return
        w = int(min(self.wave, n))
        # Wave schedule. The FIRST wave of an initial build inserts into
        # an empty graph: its nodes get mates-only links and become the
        # routing backbone every later insertion descends through. When
        # that wave is a large fraction of the corpus the graph never
        # recovers. Ramp the head (128, 128, 256, 512, ...) so every wave
        # after the first links into a frozen prefix at least its own
        # size. THRESHOLDED: when the first wave is already a tiny corpus
        # fraction (w <= n/64) the mates-only set is harmless and large
        # corpora keep the fixed-width schedule.
        schedule: list[tuple[int, int]] = []
        pos = 0
        if lo == 0 and w > 128 and w > n // 64 and WAVE_RAMP:
            ramp = [128, 128]  # two 128s: wave 2's frozen prefix == its size
            s = 256
            while s <= w // 2:
                ramp.append(s)
                s *= 2
            for s in ramp:  # sums to ~w; bounds the mates-only set to 128
                s = min(s, n - pos)
                if s <= 0:
                    break
                schedule.append((pos, s))
                pos += s
        while pos < n:
            schedule.append((pos, w))
            pos += w
        num_waves = len(schedule)
        use_cstore = bool(self.construction_store) and self._cstore_ok()
        steps: dict = {}

        def get_step(width: int):
            if width not in steps:
                steps[width] = self._make_wave_step(width, self._max_level, use_cstore)
            return steps[width]

        # post passes re-run every point against the FULL graph and never
        # need the ramp: they iterate a uniform width-w grid. When the
        # ramp fired, num_waves > num_post and wi*w indexing into the
        # ramped schedule would overrun the corpus, so size wl_all for
        # whichever loop reaches further.
        num_post = (n + w - 1) // w
        total = lo + max(schedule[-1][0], (num_post - 1) * w) + w
        wl_host = np.full(total, -1, np.int32)
        wl_host[: len(self.levels)] = self.levels
        corpus = _corpus_dict(self._graph_space, self._graph_data)
        qenc_all = self._qenc_all
        ecorpus = eqenc = None
        if self._exact_qenc_all is not None:
            ecorpus = _corpus_dict(self.space, self.data)
            eqenc = self._exact_qenc_all
        dev = self.graph["level0"].device
        wl_all = torch.from_numpy(wl_host).to(dev)

        def with_spare(adj):  # make_wave_step: one spare last row per tensor
            return torch.cat([adj, adj.new_full((1, adj.shape[1]), -1)])

        level0 = with_spare(self.graph["level0"])
        upper = [with_spare(u) for u in self._upper]
        cstore = xqc = xsc = None
        if use_cstore:
            # quantize the corpus FIRST so the [S, m0cap, d] replication
            # gather lands in int8 (f32 first would be 4x the bytes)
            vecs = corpus["vecs"]
            s = float(vecs.abs().max()) / 127.0
            xsc = s if s > 0 else 1.0
            xqc = torch.clamp(torch.round(vecs / xsc), -127, 127).to(torch.int8)
            cstore = xqc[level0.clamp(0, xqc.shape[0] - 1)]
        # ProgressDisplay analog (reference: hnsw.cc:236): one INFO line
        # per ~10% of waves when build_index(print_progress=True)
        every = max(1, num_waves // 10) if getattr(self, "progress", False) else 0
        for wi in range(num_waves):
            if every and wi % every == 0:
                # sync before logging so the line reflects true device
                # progress (dispatch is asynchronous); ~10 syncs per build
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                log("INFO", f"hnsw build: wave {wi + 1}/{num_waves}")
            off, width = schedule[wi]
            start = lo + off
            get_step(width)(
                level0, upper, start, wl_all[start:start + width], self._entry,
                start,  # frozen-prefix limit during the build
                corpus, qenc_all, cstore, xqc, xsc, ecorpus, eqenc,
            )
        # post passes: re-run every point against the FULL graph, merging
        # new neighbourhoods into existing rows (reference: hnsw.cc:251-338
        # builds a second reverse-order graph and UNION-merges per-node
        # friend lists, so the pass must merge, never replace)
        n_total = len(self.levels)
        if self.post and hi >= n_total:
            step = self._make_wave_step(w, self._max_level, use_cstore, merge_forward=True)
        for _ in range(self.post if hi >= n_total else 0):
            for wi in range(num_post - 1, -1, -1):
                start = lo + wi * w
                step(
                    level0, upper, start, wl_all[start:start + w], self._entry,
                    n_total,  # full visibility
                    corpus, qenc_all, cstore, xqc, xsc, ecorpus, eqenc,
                )
        # exact-space post passes (sketch-proxy builds only): the same
        # rebuild-and-merge loop with the sparse space traversing and
        # selecting, to rank the near-ties the sketches could not
        if self._proxy is not None and self.exact_post and eqenc is not None and hi >= n_total:
            estep = make_wave_step(
                self.space, self._n_total, w, self._max_level, efc=self.ef_construction, m=self.M,
                m0cap=self.maxM0, mcap=self.maxM, mates=min(self.wave_mates, w),
                expand=self.construction_expand, selection="none" if self.delaunay_type == 0 else "heur",
                merge_forward=True,
            )
            for _ in range(self.exact_post):
                for wi in range(num_post - 1, -1, -1):
                    start = lo + wi * w
                    estep(level0, upper, start, wl_all[start:start + w], self._entry, n_total, ecorpus, eqenc)
        # the construction store is build-only state
        cstore = xqc = None
        self.graph = {"level0": level0[:-1].clone()}
        self._upper = [u[:-1].clone() for u in upper]

    def _reorder_data(self, data, order, n):
        """The corpus with its rows in ``order`` (padding rows last): every
        row-indexed tensor field and extra of the dataclass."""
        n_pad = data.ids.shape[0]
        perm = np.concatenate([order, np.arange(n, n_pad)]).astype(np.int64)
        p = torch.from_numpy(perm).to(data.ids.device)

        def take(a):
            rowed = isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == n_pad
            return a[p] if rowed else a

        fields = {f.name: take(getattr(data, f.name)) for f in dataclasses.fields(data) if f.name != "extra"}
        return dataclasses.replace(data, **fields, extra={k: take(v) for k, v in data.extra.items()})

    # ----- the batched insertion wave -----

    def _make_wave_step(self, w: int, max_level: int, use_cstore: bool = False,
                        merge_forward: bool = False):
        return make_wave_step(
            self._graph_space,
            self._n_total,
            w,
            max_level,
            efc=self.ef_construction,
            m=self.M,
            m0cap=self.maxM0,
            mcap=self.maxM,
            mates=min(self.wave_mates, w),
            expand=self.construction_expand,
            selection="none" if self.delaunay_type == 0 else "heur",
            exact_space=self.space if self._exact_qenc_all is not None else None,
            exact_pairs=bool(self.exact_pairs),
            exact_base=bool(self.exact_base),
            exact_shrink=bool(self.exact_shrink),
            use_cstore=use_cstore,
            merge_forward=merge_forward,
        )

    def _cstore_ok(self) -> bool:
        """constructionStore needs the same shape of corpus the query-time
        nbr store does (dense f32/bf16 rows whose per-row term is
        recomputable) on the GRAPH space."""
        if self._exact_qenc_all is not None:
            return False
        corpus = _corpus_dict(self._graph_space, self._graph_data)
        vecs = corpus.get("vecs")
        # the store's gathered scorer reconstructs ONLY {x, pad}: any extra
        # layout key (a gathered 'term', a dynamic 'row_mask', another
        # space's own keys) means rows alone don't determine distances
        ok = (
            set(corpus) <= {"vecs", "count"}
            and isinstance(vecs, torch.Tensor)
            and vecs.dtype in (torch.float32, torch.bfloat16)
            and vecs.ndim == 2
        )
        if not ok and self.construction_store and self._cstore_explicit:
            # warn only on explicit opt-in: the store defaults ON and
            # silently stands down for non-eligible encodings
            log("WARNING", "hnsw: constructionStore ignored (space/encoding not dense-row eligible)")
        return ok

    # ---------------- search ----------------

    def _nbr_store_ok(self) -> bool:
        """Neighbourhood replication needs dense float rows whose per-row
        term is recomputable (or absent): corpus_dict must carry neither
        a gathered 'term' nor a dynamic 'row_mask'."""
        if not hasattr(self.data, "vecs"):
            return False
        corpus = _corpus_dict(self.space, self.data)
        vecs = corpus.get("vecs")
        return (
            "term" not in corpus
            and "row_mask" not in corpus
            and isinstance(vecs, torch.Tensor)
            and vecs.dtype in (torch.float32, torch.bfloat16)
            and vecs.ndim == 2
        )

    def aux_device_arrays(self):
        out = list(self._upper)
        if self._nbr_store is not None:
            out.append(self._nbr_store[1])
        if self._proxy is not None:
            # resident when sketchQuery=1: the sketch corpus and R
            out.append(self._proxy[1].vecs)
            out.append(self._proxy[2])
        return out

    def _get_nbr_store(self):
        """Lazy [n_pad, maxM0, d] replicated neighbour rows (level 0), in
        bf16 or symmetric per-tensor int8 (nbrStoreDtype). Cached keyed on
        the adjacency tensor's identity, so any graph mutation (rebuild)
        rebuilds it. Returns (rows, scale); scale is 1.0 for bf16."""
        if not self.replicate_neighbors or not self._nbr_store_ok():
            return None
        adj = self.graph["level0"]
        if self._nbr_store is None or self._nbr_store[0] is not adj:
            vecs = self.data.vecs
            safe = adj.clamp(0, vecs.shape[0] - 1)
            # quantize the CORPUS before the neighbour gather so the
            # [n_pad, maxM0, d] gather lands directly in the narrow dtype:
            # gathering f32 first would materialize n_pad*maxM0*d*4 bytes
            if self.nbr_store_dtype == "int8":
                s = float(vecs.abs().max()) / 127.0
                s = s if s > 0 else 1.0
                xq = torch.clamp(torch.round(vecs / s), -127, 127).to(torch.int8)
                self._nbr_store = (adj, xq[safe], s)
            else:
                self._nbr_store = (adj, vecs.to(torch.bfloat16)[safe], 1.0)
        return self._nbr_store[1], self._nbr_store[2]

    def _knn_run(self, points, k: int):
        """The caller's side of a kNN batch: validate, encode the queries
        and capture every setting the search reads (efSearch, the
        expansion, the neighbour store, the graph as it stands). Returns
        (qenc, run); run() searches on the device, adds its dist comps
        and gives (dists, ids) as tensors."""
        if self.graph is None:
            raise IndexNotBuiltError("hnsw: index not built")
        ef = max(self.ef_search, k)
        expand = self._effective_expand(ef)
        space, data, level0, upper, entry = self.space, self.data, self.graph["level0"], tuple(self._upper), self._entry
        qenc = space.encode_queries(points)
        if self._proxy is not None and self.sketch_query:
            pspace, pdata, r_mat = self._proxy
            qenc = {"exact": qenc, "sketch": space.sketch_queries(qenc, r_mat)}

            def search():
                return _search_sketch(pspace, space, qenc["sketch"], qenc["exact"], pdata, data,
                                      level0, upper, entry, ef, k, expand)
        else:
            nbr_store = self._get_nbr_store()

            def search():
                return _search_core(space, qenc, data, level0, upper, entry, ef, k, expand, nbr_store=nbr_store)

        def run():
            d, ids, nd = search()
            self._add_dist_comps(nd)
            return d, ids

        return qenc, run

    def knn(self, points, k: int):
        d, ids = self._knn_run(points, k)[1]()
        return self._finalize_knn(d.cpu().numpy(), ids.cpu().numpy())

    def knn_async(self, points, k: int):
        qenc, run = self._knn_run(points, k)
        return self._dispatch(run, self._finalize_knn, qenc)

    def range(self, points, radius):
        raise SpaceIncompatibleError("Range search is not supported!")

    # ---------------- graph sanity checkers (test infra) ----------------

    def check_graph(self) -> dict:
        """Duplicate/self-link detector (reference: checkList1,
        hnsw.cc:125-148). Returns counts; all zero for a healthy graph."""
        if self.graph is None:
            raise IndexNotBuiltError("hnsw: index not built")
        n = self._n_total
        out = {"self_links": 0, "dup_links": 0, "oob_links": 0}
        adjs = [self.graph["level0"].cpu().numpy()[:n]] + [u.cpu().numpy() for u in self._upper]
        for adj in adjs:
            rows = np.arange(adj.shape[0])[:, None]
            valid = adj >= 0
            out["self_links"] += int(np.sum((adj == rows) & valid))
            out["oob_links"] += int(np.sum(valid & (adj >= n)))
            s = np.sort(np.where(valid, adj, -np.arange(adj.size).reshape(adj.shape) - 1), axis=1)
            out["dup_links"] += int(np.sum((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)))
        return out

    def degree_distribution(self) -> np.ndarray:
        """Level-0 out-degree histogram (reference: getDegreeDistr,
        hnsw.cc:150-181). Returns counts indexed by degree 0..maxM0."""
        if self.graph is None:
            raise IndexNotBuiltError("hnsw: index not built")
        deg = np.sum(self.graph["level0"].cpu().numpy()[: self._n_total] >= 0, axis=1)
        return np.bincount(deg, minlength=self.maxM0 + 1)

    # ---------------- persistence ----------------

    def state_arrays(self) -> dict:
        out = {
            "level0": self.graph["level0"].cpu().numpy(),
            "levels": np.asarray(self.levels),
            "order": np.asarray(self.order),
            "meta": np.asarray(
                [self.M, self.maxM, self.maxM0, self.ef_construction, self._entry]
            ),
        }
        for i, u in enumerate(self._upper):
            out[f"upper_{i}"] = u.cpu().numpy()
        return out

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        if not state:
            self.create_index(store, params)
            return
        self.store = store
        self.levels = np.asarray(state["levels"])
        self.order = np.asarray(state["order"])
        meta = np.asarray(state["meta"])
        self._entry = int(meta[4]) if meta.shape[0] > 4 else 0
        n = len(store)
        # the graph tensors are already built: no construction encodings,
        # unless the method keeps them for post-build maintenance, and no
        # sketch proxy unless sketchQuery traverses it (R is drawn again
        # from the seed)
        keep_dsk = self.sketch_dim
        if not self.KEEP_WAVE_STATE and not self.sketch_query:
            self.sketch_dim = 0
        try:
            self._encode_store(store, n, skip_construction=not self.KEEP_WAVE_STATE)
        finally:
            self.sketch_dim = keep_dsk
        self._drop_wave_state()
        self._n_total = n
        self._max_level = int(self.levels.max(initial=0)) if n else 0
        dev = self.data.ids.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        self.graph = {"level0": put(state["level0"])}
        ups = sorted(
            (k for k in state if k.startswith("upper_")),
            key=lambda s: int(s.split("_")[1]),
        )
        self._upper = [put(state[k]) for k in ups]
