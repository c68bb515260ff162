"""The plain reference, and the comparison that decides ``correct``.

Plain PyTorch in float64, on the inputs that ``data.py`` made. It imports
nothing of the program and takes nothing the program made: it reads the
program's answers only to judge them.

A *form* gives, for a block of the query pool, every corpus row's exact
distance on the comparison's scale (squared L2 for ``l2``, the negated dot
for ``negdotprod_sparse``), the float32 error bound of each (query, row)
pair on that scale, and the same distances computed one precision below the
configuration's IEEE float32: TF32, operands rounded to 10 explicit
mantissa bits with products and sums in float32 (what a TF32 tensor core
does). That last one is the control: put in the program's place, it has to
come out not correct. A space this file lacks is looked up as
``knnbench/forms/<space>.py``, whose ``make(inputs, device)`` gives a form.

The numbers compared, each the worst over every answer compared:

* kNN ``rank_gap``: at each rank, the exact distance of the returned id
  against the exact distance at that rank of a float64 scan, over twice
  the float32 bound of the two rows: a float32 scan may order two rows
  whose exact distances lie within twice the bound either way, and no
  further. A missing, invalid or repeated id reads infinite.
* kNN ``dist_err``: the returned distance against its id's exact one, over
  the bound.
* range ``range_gap``: over the returned rows, how far past the radius
  each lies; over the rows inside the radius that were not returned, how
  far inside; each over the pair's bound. ``dist_err`` as for kNN.
"""

from __future__ import annotations

import numpy as np
import torch

#: float32 unit roundoff
U = 2.0 ** -24
#: bytes of the [block, n] float64 distance block the reference holds at once
_BLOCK_BYTES = 1 << 31


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties to even; finite inputs."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class DenseL2:
    """``l2``: Euclidean distance; compared as squared distances."""

    def __init__(self, inputs, device):
        self.device = device
        self.x = torch.as_tensor(inputs.corpus, device=device).double()
        self.q = torch.as_tensor(inputs.queries, device=device).double()
        self.xn2 = (self.x * self.x).sum(1)
        self.qn2 = (self.q * self.q).sum(1)
        self.xn, self.qn = self.xn2.sqrt(), self.qn2.sqrt()
        self.c = (self.x.shape[1] + 3) * U
        self._tf32 = None

    def exact(self, s: int, e: int) -> torch.Tensor:
        q = self.q[s:e]
        return (self.qn2[s:e, None] + self.xn2[None, :] - 2.0 * (q @ self.x.T)).clamp_min_(0.0)

    def pair_bound(self, qrow: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(D+3) u (|q| + |x|)^2: the float32 norm-identity bound of pool
        query ``qrow`` and corpus row ``pos`` (broadcast)."""
        return self.c * (self.qn[qrow] + self.xn[pos]) ** 2

    def to_scale(self, d: torch.Tensor) -> torch.Tensor:
        return d.double() ** 2

    def radius_scale(self, r: float) -> float:
        return float(r) ** 2

    def from_scale(self, v: torch.Tensor) -> torch.Tensor:
        return v.clamp_min(0.0).sqrt()

    def control(self, s: int, e: int) -> torch.Tensor:
        """float32 [block, n] distances at TF32, as the program returns them."""
        if self._tf32 is None:
            xt = tf32(self.x)
            self._tf32 = (xt, (xt * xt).sum(1))
        xt, xtn = self._tf32
        qt = tf32(self.q[s:e])
        d2 = (qt * qt).sum(1)[:, None] + xtn[None, :] - 2.0 * (qt @ xt.T)
        return d2.clamp_min_(0.0).sqrt_()


class SparseNegDot:
    """``negdotprod_sparse``: the negated inner product, compared as is.

    The corpus is held term-major (each term's postings), so a block of
    queries costs its matching (query term, row term) products, not
    queries x rows x vocabulary."""

    #: matching products expanded at once (each takes ~48 bytes)
    PAIRS = 1 << 26

    def __init__(self, inputs, device):
        self.device = device
        self.n = inputs.n
        indptr, cols, vals = (torch.as_tensor(a, device=device) for a in inputs.corpus)
        rows = torch.repeat_interleave(torch.arange(self.n, device=device), indptr[1:] - indptr[:-1])
        vals = vals.double()
        order = torch.argsort(cols, stable=True)
        self.post_row, self.post_val = rows[order], vals[order]
        counts = torch.bincount(cols, minlength=inputs.vocab)
        self.post_cnt = counts
        self.post_ptr = torch.cumsum(counts, 0) - counts
        self.xn = torch.zeros(self.n, dtype=torch.float64, device=device).index_add_(0, rows, vals * vals).sqrt()
        qptr, qcols, qvals = (torch.as_tensor(a, device=device) for a in inputs.queries)
        self.qptr, self.qcols, self.qvals = qptr, qcols, qvals.double()
        qlen = qptr[1:] - qptr[:-1]
        qrows = torch.repeat_interleave(torch.arange(len(qlen), device=device), qlen)
        self.qn = torch.zeros(len(qlen), dtype=torch.float64, device=device).index_add_(
            0, qrows, self.qvals * self.qvals).sqrt()
        self.qlen = qlen.double()

    def _dots(self, s: int, e: int, dtype, round_tf32: bool) -> torch.Tensor:
        """[e - s, n] dots of queries s..e with every row, in ``dtype``."""
        out = torch.zeros((e - s, self.n), dtype=dtype, device=self.device)
        lo, hi = int(self.qptr[s]), int(self.qptr[e])
        qrow = torch.repeat_interleave(torch.arange(e - s, device=self.device), self.qptr[s + 1:e + 1] - self.qptr[s:e])
        qcol, qval = self.qcols[lo:hi], self.qvals[lo:hi].to(dtype)
        pval = self.post_val.to(dtype)
        if round_tf32:
            qval, pval = tf32(qval), tf32(pval)
        cnt = self.post_cnt[qcol]
        ends = torch.cumsum(cnt, 0)
        flat = out.view(-1)
        a = 0
        while a < len(qcol):  # slices of the block's query terms, PAIRS products at most (one term may exceed it)
            b = max(a + 1, int(torch.searchsorted(ends, int(ends[a] - cnt[a]) + self.PAIRS, right=True)))
            c = cnt[a:b]
            ent = torch.repeat_interleave(torch.arange(a, b, device=self.device), c)
            first = torch.cumsum(c, 0) - c
            off = torch.arange(len(ent), device=self.device) - torch.repeat_interleave(first, c)
            p = self.post_ptr[qcol[ent]] + off
            flat.index_add_(0, qrow[ent] * self.n + self.post_row[p], qval[ent] * pval[p])
            a = b
        return out

    def exact(self, s: int, e: int) -> torch.Tensor:
        return self._dots(s, e, torch.float64, False).neg_()

    def pair_bound(self, qrow: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(L + 2) u |q||x|: a float32 dot of at most L = the query's
        non-zeros products, and its negation."""
        return (self.qlen[qrow] + 2.0) * U * self.qn[qrow] * self.xn[pos]

    def to_scale(self, d: torch.Tensor) -> torch.Tensor:
        return d.double()

    def control(self, s: int, e: int) -> torch.Tensor:
        return self._dots(s, e, torch.float32, True).neg_()


FORMS = {"l2": DenseL2, "negdotprod_sparse": SparseNegDot}


def make_form(space: str, inputs, device):
    if space in FORMS:
        return FORMS[space](inputs, device)
    from .registry import find

    return find("forms", space).make(inputs, device)


def _block_rows(form) -> int:
    return max(1, _BLOCK_BYTES // (8 * form.xn.shape[0]))


def _no_repeats(pos: torch.Tensor) -> torch.Tensor:
    """bool [Q]: no id twice in a row of positions."""
    srt = torch.sort(pos, dim=1).values
    return ~(srt[:, 1:] == srt[:, :-1]).any(1)


def _worst(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


class Reference:
    """The reference over one seed's query pool. ``pos_of_id`` maps the
    program's object ids back to corpus rows."""

    def __init__(self, inputs, space: str, device):
        self.inputs = inputs
        self.form = make_form(space, inputs, device)
        self.device = device
        ids = np.asarray(inputs.ids, np.int64)
        self.pos_of_id = np.full(int(ids.max()) + 1, -1, np.int64)
        self.pos_of_id[ids] = np.arange(len(ids))

    def _positions(self, ids: np.ndarray) -> torch.Tensor:
        ids = np.asarray(ids, np.int64)
        ok = (ids >= 0) & (ids < len(self.pos_of_id))
        pos = np.where(ok, self.pos_of_id[np.where(ok, ids, 0)], -1)
        return torch.as_tensor(pos, device=self.device)

    def _blocks(self, b: int):
        """(s, e) query-pool row ranges of pool batch ``b``, in blocks the
        float64 distance block fits."""
        s0, e0 = self.inputs.batch_rows(b)
        step = _block_rows(self.form)
        for s in range(s0, e0, step):
            yield s, min(s + step, e0)

    # -- kNN --

    def knn(self, answers: dict, k: int) -> dict:
        """``answers``: pool batch -> list of distinct (dists [B, k], ids [B, k])
        the program returned for it. Returns the worst ``rank_gap`` and
        ``dist_err``."""
        gap = err = 0.0
        for b, outs in answers.items():
            s0 = self.inputs.batch_rows(b)[0]
            for s, e in self._blocks(b):
                ex = self.form.exact(s, e)
                oe, opos = torch.topk(ex, k, dim=1, largest=False)
                for d, ids in outs:
                    g, r = self._knn_block(ex, oe, opos, s, e, d[s - s0:e - s0], ids[s - s0:e - s0])
                    gap, err = max(gap, g), max(err, r)
                del ex
        return {"rank_gap": gap, "dist_err": err}

    def _knn_block(self, ex, oe, opos, s, e, d, ids):
        form = self.form
        pos = self._positions(ids)
        if pos.shape != oe.shape:
            return float("inf"), float("inf")
        d = torch.as_tensor(np.asarray(d), device=self.device)
        ok = (pos >= 0).all(1) & _no_repeats(pos)
        safe = pos.clamp_min(0)
        pe = torch.gather(ex, 1, safe)
        qrow = torch.arange(s, e, device=self.device)[:, None]
        b_ret = form.pair_bound(qrow, safe)
        gap = (pe - oe).abs() / (2.0 * torch.maximum(b_ret, form.pair_bound(qrow, opos)))
        err = (form.to_scale(d) - pe).abs() / b_ret
        err = torch.where(torch.isfinite(d), err, torch.inf)
        inf = torch.tensor(float("inf"), dtype=gap.dtype, device=gap.device)
        gap = torch.where(ok[:, None], gap, inf)
        err = torch.where(ok[:, None], err, inf)
        return _worst(gap), _worst(err)

    def control_knn(self, k: int) -> dict:
        """The control's answers for every pool batch, as the program's."""
        out = {}
        for b in range(self.inputs.pool):
            ds, ids = [], []
            for s, e in self._blocks(b):
                d, pos = torch.topk(self.form.control(s, e), k, dim=1, largest=False)
                ds.append(d.cpu().numpy())
                ids.append(self.inputs.ids[pos.cpu().numpy()])
            out[b] = [(np.concatenate(ds), np.concatenate(ids))]
        return out

    # -- range --

    def radius(self, kth: int, quantile: float) -> float:
        """The ``quantile`` over the pool of each query's ``kth``-neighbour
        distance, as a float32 value (the program compares in float32)."""
        vals = []
        for b in range(self.inputs.pool):
            for s, e in self._blocks(b):
                vals.append(torch.topk(self.form.exact(s, e), kth, dim=1, largest=False).values[:, -1])
        kth_d = self.form.from_scale(torch.cat(vals))
        return float(np.float32(torch.quantile(kth_d, quantile).item()))

    def range(self, answers: dict, radius: float) -> dict:
        """``answers``: pool batch -> list of distinct answers, each a list of
        (ids, dists) a query. Returns the worst ``range_gap`` and
        ``dist_err``."""
        form = self.form
        r2 = form.radius_scale(radius)
        gap = err = 0.0
        for b, outs in answers.items():
            s0 = self.inputs.batch_rows(b)[0]
            for s, e in self._blocks(b):
                ex = form.exact(s, e)
                inside = ex < r2
                for res in outs:
                    g, r = self._range_block(ex, inside, s, e, res[s - s0:e - s0], r2)
                    gap, err = max(gap, g), max(err, r)
                del ex, inside
        return {"range_gap": gap, "dist_err": err}

    def _range_block(self, ex, inside, s, e, res, r2):
        form = self.form
        if len(res) != e - s:
            return float("inf"), float("inf")
        lens = [len(ids) for ids, _ in res]
        qi = torch.repeat_interleave(torch.arange(e - s, device=self.device),
                                     torch.as_tensor(lens, device=self.device))
        ids = np.concatenate([np.asarray(i, np.int64) for i, _ in res]) if res else np.zeros(0, np.int64)
        d = torch.as_tensor(np.concatenate([np.asarray(x, np.float32) for _, x in res]) if res else
                            np.zeros(0, np.float32), device=self.device)
        pos = self._positions(ids)
        if bool((pos < 0).any()):
            return float("inf"), float("inf")
        hit = torch.zeros_like(ex, dtype=torch.int32)
        hit.index_put_((qi, pos), torch.ones_like(pos, dtype=torch.int32), accumulate=True)
        if bool((hit > 1).any()):
            return float("inf"), float("inf")
        pe = ex[qi, pos]
        band = self._band(s, qi, pos, r2)
        over = (pe - r2) / band
        err = torch.where(torch.isfinite(d), (form.to_scale(d) - pe).abs() / band, torch.inf)
        mq, mp = torch.nonzero(inside & (hit == 0), as_tuple=True)
        under = (r2 - ex[mq, mp]) / self._band(s, mq, mp, r2)
        return max(0.0, _worst(over), _worst(under)), _worst(err)

    def _band(self, s, qi, pos, r2):
        """Bound of pairs (pool row s + qi, corpus row pos) against the
        radius: the pair's, plus the rounding of the square root and of the
        comparison (u r^2 each, twice over)."""
        return self.form.pair_bound(qi + s, pos) + 4 * U * r2

    def control_range(self, radius: float) -> dict:
        """The control's range answers for every pool batch, as the program's."""
        out = {}
        for b in range(self.inputs.pool):
            res = []
            for s, e in self._blocks(b):
                d = self.form.control(s, e)
                for row in d:
                    pos = torch.nonzero(row <= radius).flatten()
                    dd, order = torch.sort(row[pos], stable=True)
                    p = pos[order].cpu().numpy()
                    res.append((self.inputs.ids[p], dd.cpu().numpy()))
            out[b] = [res]
        return out
