"""Inverted-index (term-at-a-time, TAAT) sparse scoring (counterpart of
tpu_knn/ops/inverted.py; reference: simple_inverted_index.cc:47-260, a
DAAT heap merge over posting lists).

A posting-list engine touches only the postings of the batch's query
terms, sum over t of |P_t|, where the exact scan touches every corpus
element: it owns the small-batch regime, and the scan the large one.

Layout, as in tpu_knn:
  * postings are stored per term in 128-slot BLOCKs, [PB + 1, 128] doc and
    value arrays (the last block all padding), so a term's postings are
    whole-block row gathers;
  * the host plans a batch (:func:`plan_batch`): the union of the query
    terms gives a block list and a per-union-term weight table W [U, nq];
  * the device gathers the posting blocks, forms the contributions
    val[p] * W[term(p), q] in slices of at most 2048 blocks, adds them
    into a [n_rows, nq] score accumulator, then takes a streaming top-k
    over the accumulator in which a document no query term touched (score
    exactly 0) stays at +inf, like a DAAT heap that never saw it.

How the port differs inside: tpu_knn adds with a float scatter-add, which
XLA's CPU code runs one update after another, so each (document, query)
cell is summed in union-term order (blocks ascending, then slots). On a
GPU a float ``index_add_`` is an atomic add in no fixed order, which would
break "same input, same bits" and make a query's result depend on its
batch. The port sums each cell in XLA's order without atomics
(:func:`_add_slice`): a stable sort of a slice's postings by document
gives each posting its rank among the document's postings in the slice
(its term order), and round r adds every document's rank-r contribution
with a gather, an add and a scatter to distinct rows. Both devices run
this formulation; on the CPU it gives tpu_knn's bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import topk as T
from .topk import INF

BLOCK = 128
#: Posting blocks a contribution slice holds: [2048, 128, nq] f32 at once
#: (all of a big batch's contributions would not fit: 16 GB at 64k blocks
#: and nq=512).
SLICE_BLOCKS = 2048


def _round_pow2(n: int, lo: int = 16) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@dataclass
class InvertedPostings:
    """128-aligned CSC posting blocks (device) + host slice directory."""

    pdoc_blocks: torch.Tensor  # i32[PB+1, 128]; doc row index, -1 pad (last block all pad)
    pval_blocks: torch.Tensor  # f32[PB+1, 128]; 0 pad
    blk_start: np.ndarray  # host i64[V]: first block of term t (0-based terms)
    blk_count: np.ndarray  # host i64[V]: blocks of term t
    vocab: int
    n_rows: int  # padded corpus row count (accumulator height)
    total_postings: int


def build_postings(col: np.ndarray, val: np.ndarray, count: int, n_rows: int,
                   device="cpu") -> InvertedPostings:
    """Host-side CSC build from the padded-CSR corpus arrays, uploaded to
    ``device``.

    ``col`` [N_pad, nnz] holds 1-based term ids with val==0 padding
    (spaces/sparse._pack_csr). Postings keep doc order ascending within
    each term (stable sort of the doc-major ravel), matching the
    reference's sorted posting lists (simple_inverted_index.cc:96-118).
    """
    cols = col[:count].ravel().astype(np.int64)
    vals = val[:count].ravel()
    docs = np.repeat(np.arange(count, dtype=np.int32), col.shape[1])
    keep = vals != 0
    cols, vals, docs = cols[keep] - 1, vals[keep], docs[keep]
    vocab = int(cols.max()) + 1 if cols.size else 1
    # the same stable order; 16-bit keys take numpy's radix sort (~6x faster)
    order = np.argsort(cols.astype(np.uint16) if vocab <= 1 << 16 else cols, kind="stable")
    cols, vals, docs = cols[order], vals[order], docs[order]
    plen = np.bincount(cols, minlength=vocab).astype(np.int64)
    blk_count = (plen + BLOCK - 1) // BLOCK
    blk_start = np.concatenate([[0], np.cumsum(blk_count)])[:-1]
    pb = int(blk_count.sum())
    pdoc = np.full((pb + 1) * BLOCK, -1, np.int32)  # +1: dead pad block
    pval = np.zeros((pb + 1) * BLOCK, np.float32)
    src_off = np.concatenate([[0], np.cumsum(plen)])[:-1]
    within = np.arange(cols.size, dtype=np.int64) - src_off[cols]
    dst = blk_start[cols] * BLOCK + within
    pdoc[dst] = docs
    pval[dst] = vals
    return InvertedPostings(
        pdoc_blocks=torch.from_numpy(pdoc.reshape(-1, BLOCK)).to(device),
        pval_blocks=torch.from_numpy(pval.reshape(-1, BLOCK)).to(device),
        blk_start=blk_start,
        blk_count=blk_count,
        vocab=vocab,
        n_rows=n_rows,
        total_postings=int(cols.size),
    )


def plan_batch(qcol: np.ndarray, qval: np.ndarray, inv: InvertedPostings):
    """Host-side batch plan: (block_ids [NB_pad], ublock [NB_pad],
    W [U_pad, nq]), sized per BLOCK and per term, padded to power-of-two
    buckets with the dead block and a zero W row, as tpu_knn plans it."""
    nq = qcol.shape[0]
    valid = qval != 0
    terms = qcol[valid].astype(np.int64) - 1
    qidx = np.broadcast_to(np.arange(nq)[:, None], qcol.shape)[valid]
    inrange = (terms >= 0) & (terms < inv.vocab)
    terms, qidx, tvals = terms[inrange], qidx[inrange], qval[valid][inrange]
    union, uinv = np.unique(terms, return_inverse=True)
    nonempty = inv.blk_count[union] > 0
    # remap to the non-empty union only
    new_id = np.cumsum(nonempty) - 1
    u_terms = union[nonempty]
    u = int(u_terms.size)
    w = np.zeros((_round_pow2(u + 1), nq), np.float32)
    ok = nonempty[uinv]
    np.add.at(w, (new_id[uinv[ok]], qidx[ok]), tvals[ok])
    nb_u = inv.blk_count[u_terms]
    nb = int(nb_u.sum())
    nb_pad = _round_pow2(max(nb, 1))
    dead_blk = inv.pdoc_blocks.shape[0] - 1
    block_ids = np.full(nb_pad, dead_blk, np.int32)
    ublock = np.full(nb_pad, w.shape[0] - 1, np.int32)  # pad -> zero W row
    if nb:
        boff = np.concatenate([[0], np.cumsum(nb_u)])[:-1]
        flat = np.arange(nb, dtype=np.int64)
        seg = np.searchsorted(np.cumsum(nb_u), flat, side="right")
        block_ids[:nb] = (inv.blk_start[u_terms[seg]] + flat - boff[seg]).astype(np.int32)
        ublock[:nb] = seg.astype(np.int32)  # seg IS the compact union index
    return block_ids, ublock, w


def _add_slice(scores: torch.Tensor, doc: torch.Tensor, val: torch.Tensor, ub: torch.Tensor,
               w: torch.Tensor) -> None:
    """scores[doc[p]] += val[p] * w[ub[p]] for every real posting p of a
    slice (doc >= 0), each (document, query) cell summed in posting order
    with no atomics: round r adds each document's r-th posting of the slice,
    so a round's rows are distinct and a document's rounds run in order."""
    n_rows = scores.shape[0]
    pos = torch.arange(doc.shape[0], device=doc.device)
    tgt = torch.where(doc >= 0, doc, n_rows).to(torch.int64)  # pads sort last
    sd, by_doc = torch.sort(tgt, stable=True)
    first = torch.ones_like(sd, dtype=torch.bool)
    first[1:] = sd[1:] != sd[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.where(sd < n_rows, pos - run_start, doc.shape[0])  # pads: past every round
    rank_sorted, by_rank = torch.sort(rank, stable=True)
    order = by_doc[by_rank]  # postings by (rank, document)
    # one host read a slice: the number of postings of each round
    counts = torch.bincount(rank_sorted[rank_sorted < doc.shape[0]]).tolist()
    off = 0
    for c in counts:
        p = order[off:off + c]
        off += c
        rows = tgt[p]
        contrib = val[p][:, None] * w[ub[p]]
        scores.index_copy_(0, rows, scores.index_select(0, rows) + contrib)


def taat_topk(pdoc_blocks, pval_blocks, block_ids: np.ndarray, ublock: np.ndarray, w: np.ndarray,
              corpus_ids: torch.Tensor, k: int, chunk: int):
    """Score the planned posting blocks and return (dists [nq, k], ids
    [nq, k], touched [nq]) with dist = -accumulated dot (the negdotprod
    convention; untouched docs are +inf like a DAAT heap that never saw
    them). The plan arrives as host arrays; only its real blocks are
    scored (the dead padding blocks add nothing). The top-k streams over
    ``chunk``-row slices of the accumulator, the last one ragged; the
    result does not depend on ``chunk``."""
    dev = pdoc_blocks.device
    nq = w.shape[1]
    n_rows = corpus_ids.shape[0]
    nb = int(np.count_nonzero(block_ids != pdoc_blocks.shape[0] - 1))
    w_dev = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
    scores = torch.zeros((n_rows, nq), dtype=torch.float32, device=dev)
    for s in range(0, nb, SLICE_BLOCKS):
        bl = torch.from_numpy(block_ids[s:min(s + SLICE_BLOCKS, nb)].astype(np.int64)).to(dev)
        ub = torch.from_numpy(ublock[s:min(s + SLICE_BLOCKS, nb)].astype(np.int64)).to(dev)
        _add_slice(scores, pdoc_blocks[bl].reshape(-1), pval_blocks[bl].reshape(-1),
                   ub.repeat_interleave(BLOCK), w_dev)

    fd = torch.full((nq, k), INF, dtype=torch.float32, device=dev)
    fi = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    touched = torch.zeros(nq, dtype=torch.int32, device=dev)
    for c0 in range(0, n_rows, chunk):
        st = scores[c0:c0 + chunk].T  # [nq, C], the last slice ragged
        hit = st != 0.0
        d = torch.where(hit, -st, INF)
        cols = torch.arange(c0, c0 + st.shape[1], device=dev).expand(nq, st.shape[1])
        fd, fi = T.merge_topk(fd, fi, d, cols, k)
        touched += hit.sum(dim=1, dtype=torch.int32)
    ids = torch.where(fi >= 0, corpus_ids[fi.clamp(0, n_rows - 1)], -1)
    return fd, ids, touched
