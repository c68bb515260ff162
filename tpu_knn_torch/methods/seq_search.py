"""Exact brute-force scan: seq_search / brute_force (counterpart of
tpu_knn/methods/seq_search.py).

Reference: include/method/seqsearch.h, src/method/seqsearch.cc, a
per-object loop. Here it is a blocked scan over the whole query batch.
kNN takes one of two routes (:meth:`SeqSearch._plan_knn`):

  * single pass (:func:`_knn_device`): a chunked matmul scan with a
    streaming top-k, for small corpora;
  * two passes (:func:`_knn_device_twopass`): pass 1 keeps only each
    128-row group's min of the distance block (the group-min kernel,
    ops/groupmin.py, at the f32, int8, bf16x3 or bf16 tier), a
    top-(k+margin) over the [Q, N/128] mins selects groups that provably
    hold the exact top-k (ops/topk.py GROUP; for the reduced tiers under a
    certificate with a per-block f32 redo), and pass 2 gathers those
    groups' rows and re-scores them exactly.

Range search (:meth:`SeqSearch.range`) streams [Q, chunk] blocks of
``space.block`` twice: once to count the hits per query, once to keep a
running smallest-``cap`` of them (:func:`_range_counts_device`,
:func:`_range_collect_device`).

This method is also the gold-standard generator of the evaluation
harness (gold_standard.h:151-174).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataStore, round_up
from ..core.errors import IndexNotBuiltError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import groupmin as GM
from ..ops import topk as T
from ..ops.graph import gather_row_groups, score_gathered
from ..spaces.dense import ensure_cert_metadata
from .base import Method, stream_range_results

#: Worst-case certificate coefficients (|err| <= coeff * |q| * |x|), used
#: only when the residual norms of ensure_cert_metadata are unavailable.
_PASS1_ERR_COEFF = {"high": 2.0**-14, "bfloat16": 2.0**-5.5}
#: Extra groups pass 2 re-scans beyond k, per pass-1 tier (pass-2 cost vs
#: certificate pass rate). The f32 kernel sums in another order than
#: pass 2; its margin absorbs that jitter.
_PASS1_MARGIN = {"float32": 2, "high": 2, "bfloat16": 8}
#: bf16 mma passes the tier's kernel adds into its one accumulator
_PASS1_PASSES = {"high": 3, "bfloat16": 1}
#: Queries per certificate block: a block with a failing query re-runs
#: the f32 kernel (tpu_knn's 256-query lax.map blocks).
_CERT_QBLK = 256
#: Queries per pass-2 block: [B, kg*128, D] gathered rows bound memory
#: (805 MB at B=1024, kg=12, D=128 in f32).
_PASS2_QBLK = 1024


def _ids_of(data, pos: torch.Tensor) -> torch.Tensor:
    """Object ids of corpus positions, in ``data.ids``' dtype (int32, as
    tpu_knn returns them); -1 where ``pos`` < 0."""
    n_pad = data.ids.shape[0]
    return torch.where(pos >= 0, data.ids[pos.clamp(0, n_pad - 1)], -1)


def _knn_device(space, qenc, data, k: int, chunk: int, precision: str):
    """Single-pass scan: [Q, chunk] blocks merged into a running top-k."""
    nq = qenc["q"].shape[0]
    num_chunks = data.ids.shape[0] // chunk

    def chunk_dists(ci):
        return space.block(qenc, space.slice_data(data, ci * chunk, chunk), precision)

    d, pos = T.streaming_smallest_k(chunk_dists, num_chunks, chunk, nq, k, data.vecs.device)
    return d, _ids_of(data, pos), pos


def _acc_slack(tier: str, d: int) -> float:
    """Bound, in units of |q||x|, on the accumulation error of the reduced
    tier's kernel (csrc/groupmin_wgmma.cu) against the exact sum of its
    bf16 products.

    tpu_knn's _pass1_eps takes D*2^-24 here: sequential round-to-nearest
    f32 accumulation of D terms (Higham 2002 eq. 4.2). Hopper's tensor
    cores do not accumulate that way. Each k16 step of a wgmma m64nNk16
    adds 16 exact products to the running f32 sum of each output after
    aligning all 17 addends to the largest one and truncating the bits
    shifted out, then truncates the normalized result (Fasi, Higham,
    Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor cores",
    PeerJ CS 7:e330, 2021, measured for mma; the same model is assumed for
    wgmma). So each step loses at most 18 ulps of its largest addend or
    result, each ulp at most 2^-23 of that magnitude (truncation: no extra
    guard bits assumed). Every addend and partial sum is at most the sum
    of the |products|, which Cauchy-Schwarz bounds by |hi_q||hi_x| +
    |hi_q||lo_x| + |lo_q||hi_x| <= (1 + 2^-5)|q||x| since |hi| <= (1 +
    2^-8)|v| and |lo| <= 2^-8|v|. The kernel issues, into ONE accumulator
    per output and in k order, ``passes`` k16 steps per 16 k (hi.hi,
    hi.lo, lo.hi for bf16x3; hi.hi for bf16), ceil(D/16) per pass; a
    partial last step reads zeros, which add no error. The slack does not
    depend on how the steps are grouped into wgmma commit groups:

        slack = passes * ceil(D/16) * 18 * 2^-23 * (1 + 2^-5)

    i.e. 3*D*(9/8)*2^-23*(1 + 2^-5) for bf16x3 at D % 16 == 0.
    tests/test_torch_slack.py holds a numpy emulation of this
    accumulation, in the kernel's order, within it."""
    return _PASS1_PASSES[tier] * (-(-d // 16)) * 18 * 2.0**-23 * (1 + 2.0**-5)


def _pass1_eps(qv, data, scale: float, tier: str):
    """Rigorous per-query bound f32[Q] on |reduced-precision pass-1 score -
    f32 score|: tpu_knn's _pass1_eps term for term (data-adaptive via the
    exactly computed bf16 rounding residuals, Cauchy-Schwarz on the
    omitted terms), except its accumulation slack D*2^-24*|q||x|, which
    becomes :func:`_acc_slack` of the port's kernel. The port's eps is
    therefore tpu_knn's plus |scale|*(_acc_slack - D*2^-24)*|q|*X_N in
    both branches, and never below it.

    Writing q = hi_q + lo_q with hi_q = bf16(q) (same for x), the 'high'
    kernel computes hi_q.hi_x + hi_q.bf16(lo_x) + bf16(lo_q).hi_x, which
    deviates from the true dot by lo_q.lo_x + hi_q.(lo_x - bf16(lo_x)) +
    (lo_q - bf16(lo_q)).hi_x, bounded by |lo_q|*X_LO + |q|*X_BLE +
    Q_BLE*X_N with the row maxima X_LO = max|x - bf16(x)|, X_BLE =
    max|lo_x - bf16(lo_x)| and X_N = max|x| of ensure_cert_metadata. The
    'bfloat16' tier computes hi_q.hi_x, deviating by hi_q.lo_x + lo_q.hi_x
    + lo_q.lo_x."""
    qf = qv.float()
    q_norm = torch.sqrt(torch.sum(qf * qf, dim=1))
    x_n_sq = data.extra.get("max_sq_norm")
    if x_n_sq is None:
        x_n_sq = torch.max(torch.sum(data.vecs.float() ** 2, dim=1))
    x_n = torch.sqrt(x_n_sq)
    d = qf.shape[1]
    x_lo = data.extra.get("max_lo_norm")
    if x_lo is None:  # coarse worst-case fallback
        extra = (_acc_slack(tier, d) - d * 2.0**-24) * q_norm * x_n
        return _PASS1_ERR_COEFF[tier] * abs(scale) * q_norm * x_n + abs(scale) * extra
    x_ble = data.extra.get("max_blo_err", x_lo)
    q_hi = qf.to(torch.bfloat16).float()
    q_lo = qf - q_hi
    q_lo_norm = torch.sqrt(torch.sum(q_lo * q_lo, dim=1))
    if tier == "high":
        q_ble = q_lo - q_lo.to(torch.bfloat16).float()
        q_ble_norm = torch.sqrt(torch.sum(q_ble * q_ble, dim=1))
        err = q_lo_norm * x_lo + q_norm * x_ble + q_ble_norm * x_n
    else:  # single-pass bf16
        err = (q_norm + q_lo_norm) * x_lo + q_lo_norm * (x_n + x_lo)
    acc = _acc_slack(tier, d) * q_norm * x_n
    return abs(scale) * (1.5 * err + acc)


def _certificate_ok(vals, k: int, eps):
    """Exactness certificate for reduced-precision pass 1, per query
    (bool[Q]; tpu_knn's returns their conjunction over the batch).

    ``vals``: ascending reduced-precision group mins f32[Q, kg+1] (the kg
    selected groups' mins plus the first unselected one); ``eps``: f32[Q]
    bound on |reduced-precision - exact| score.

    An unselected group g has reduced min >= vals[:, kg], hence true min
    >= vals[:, kg] - eps. The true k-th best distance tau is at most the
    k-th smallest true group min <= vals[:, k-1] + eps. Group g can contain
    a true top-k entry only if its true min <= tau, so when vals[:, kg] >
    vals[:, k-1] + 2*eps, the selected groups provably contain the
    query's exact top-k."""
    return vals[:, -1] > vals[:, k - 1] + 2.0 * eps


def _kernel_inputs(space, qenc, data):
    """(q, q_term, x_term, scale) of the group-min kernel for an affine space."""
    aff = space.pass1_affine()
    if aff is None:
        raise NotImplementedError(
            f"two-pass scan of {space.name!r}: only affine-factored spaces are ported (ROADMAP.md)"
        )
    scale, sq, sx = aff
    q = qenc["q"]
    qt = qenc.get("q_term")
    if qt is None or sq == 0.0:
        qt = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    else:
        qt = sq * qt
    xt = data.extra["pad"]
    if data.row_term is not None and sx != 0.0:
        xt = xt + sx * data.row_term
    return q, qt, xt, scale


def _kept_groups(k: int, n_groups: int, tier: str = "float32") -> int:
    """kg: the number of groups pass 2 re-scans for a top-k at ``tier``."""
    return min(k + _PASS1_MARGIN[tier], n_groups)


def _select_groups(mins: torch.Tensor, k: int, tier: str = "float32") -> torch.Tensor:
    """Groups [Q, kg] of the kg smallest group mins (ascending, ties by
    lower group), as an exact pass 1 selects them."""
    return T.smallest_k(mins, _kept_groups(k, mins.shape[1], tier))[1]


def _pass1(space, qenc, data, tier: str = "float32") -> torch.Tensor:
    """Group mins f32[Q, N_pad/128] of the affine surrogate distance at
    ``tier`` (int8 corpora always run the exact int8 tier)."""
    q, qt, xt, scale = _kernel_inputs(space, qenc, data)
    return GM.fused_groupmin(q, data.vecs, qt, xt, scale, precision=tier)


def _pass1_certified(space, qenc, data, k: int, tier: str):
    """Reduced-precision pass 1 under the certificate (tpu_knn
    seq_search.py:291-334). A top-(kg+1) over the reduced mins gives the kg
    selected groups and the first unselected one; a query is certified
    by :func:`_certificate_ok`.
    Only the 256-query blocks that hold a failing query re-run the f32
    kernel on their queries and replace their group selection.

    Returns (gsel [Q, kg], certified fraction as a 0-d tensor, number of
    redone blocks)."""
    q, qt, xt, scale = _kernel_inputs(space, qenc, data)
    nq = q.shape[0]
    kg = _kept_groups(k, data.ids.shape[0] // T.GROUP, tier)
    mins = GM.fused_groupmin(q, data.vecs, qt, xt, scale, precision=tier)
    vals, gsel1 = T.smallest_k(mins, kg + 1)
    ok_q = _certificate_ok(vals, k, _pass1_eps(q, data, scale, tier))
    gsel = gsel1[:, :kg].contiguous()
    nb = -(-nq // _CERT_QBLK)
    ok_b = torch.cat([ok_q, ok_q.new_ones(nb * _CERT_QBLK - nq)]).view(nb, _CERT_QBLK).all(dim=1)
    # the certificate's one host sync per batch: ceil(Q/256) block flags
    redo = [b for b, ok in enumerate(ok_b.cpu().tolist()) if not ok]
    for b in redo:
        s, e = b * _CERT_QBLK, min((b + 1) * _CERT_QBLK, nq)
        mins_b = GM.fused_groupmin(q[s:e], data.vecs, qt[s:e], xt, scale, precision="float32")
        gsel[s:e] = _select_groups(mins_b, k, tier)
    return gsel, ok_q.float().mean(), len(redo)


def _pass2(space, qenc, data, gsel: torch.Tensor, k: int):
    """Gather the selected groups' contiguous rows, re-score exactly,
    in blocks of _PASS2_QBLK queries. Returns ([Q, k] dists, positions).
    0-d query entries (l2sqr_sift's ``_dimconst``) go to every block."""
    nq = gsel.shape[0]
    corpus = space.corpus_dict(data)
    dks, poss = [], []
    for b0 in range(0, nq, _PASS2_QBLK):
        b1 = min(b0 + _PASS2_QBLK, nq)
        qe = {key: (v[b0:b1] if v.ndim >= 1 and v.shape[0] == nq else v) for key, v in qenc.items()}
        rows, pad, extras, cols = gather_row_groups(corpus, gsel[b0:b1], T.GROUP)
        d = score_gathered(space, qe, rows, pad, extras)  # [B, kg*128]
        dk, sel = T.smallest_k(d, k)
        dks.append(dk)
        poss.append(torch.gather(cols, 1, sel))
    return torch.cat(dks), torch.cat(poss)


def _knn_device_twopass(space, qenc, data, k: int, precision: str, pass1_precision: str = "float32"):
    """Two-pass exact scan.

    Pass 1 runs the fused group-min kernel; one top-(k+margin) over the
    [Q, N/128] mins selects groups in lax.top_k's order (ascending min,
    ties by lower group), pass 2 re-scores their rows exactly and takes
    the final top-k. The kernel scans the whole corpus in one launch.

    ``pass1_precision`` "high" or "bfloat16" runs pass 1 at a reduced tier
    without losing exactness, under the certificate of
    :func:`_pass1_certified` (f32 corpora only, and only when kg+1 groups
    exist). Pass 2 always re-scores in f32, so the distances a reduced
    tier returns are bit-identical to the f32 tier's. int8 corpora run the
    exact int8 tier whatever the precision.

    ``precision`` (the single-pass scan's matmul tier) plays no part here:
    pass 1 runs its kernel tier and pass 2 is always f32, as in tpu_knn.

    Returns (dists, ids, positions, certified fraction, redone blocks), the
    first four as tpu_knn's."""
    n_groups = data.ids.shape[0] // T.GROUP
    use_cert = (
        pass1_precision != "float32"
        and data.vecs.dtype != torch.int8  # int8 pass 1 is already exact
        and _kept_groups(k, n_groups, pass1_precision) + 1 <= n_groups
    )
    ok, redone = 1.0, 0
    if use_cert:
        gsel, ok, redone = _pass1_certified(space, qenc, data, k, pass1_precision)
    else:
        gsel = _select_groups(_pass1(space, qenc, data), k)  # [Q, kg] group indices
    dk, pos = _pass2(space, qenc, data, gsel, k)
    pos = torch.where(torch.isinf(dk), -1, pos)
    return dk, _ids_of(data, pos), pos, ok, redone


def _range_counts_device(space, qenc, data, radius: float, chunk: int, precision: str):
    """Per-query |{x : d(q,x) <= radius}| as i32[Q]: one chunked scan, never
    [Q, N] (reference seqsearch.cc:109-141; padded corpus rows carry a 1e30
    term, so the radius test drops them)."""
    nq = qenc["q"].shape[0]
    acc = torch.zeros(nq, dtype=torch.int32, device=data.vecs.device)
    for ci in range(data.ids.shape[0] // chunk):
        d = space.block(qenc, space.slice_data(data, ci * chunk, chunk), precision)
        acc += (d <= radius).sum(dim=1, dtype=torch.int32)
    return acc


def _range_collect_device(space, qenc, data, radius: float, cap: int, chunk: int, precision: str):
    """Hits within ``radius`` as ascending ([Q, cap] dists, positions);
    slots past a query's count are (+inf, -1). A streaming smallest-``cap``
    merge per chunk: device memory stays O(Q * (cap + chunk))."""

    def chunk_dists(ci):
        d = space.block(qenc, space.slice_data(data, ci * chunk, chunk), precision)
        return torch.where(d <= radius, d, T.INF)

    return T.streaming_smallest_k(
        chunk_dists, data.ids.shape[0] // chunk, chunk, qenc["q"].shape[0], cap, data.vecs.device
    )


@register_method("brute_force")  # the reference's PRIMARY registry name
@register_method("seq_search")  # (seqsearch.h:22-23: brute_force, seq_search)
class SeqSearch(Method):
    """Exact kNN / range scan; the correctness oracle for every ANN method."""

    name = "seq_search"
    supports_range = True

    DEFAULT_CHUNK = 8192

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        # Reference-parity knobs (seqsearch.cc:52-71): accepted, with the
        # threading ones subsumed by batching.
        self.copy_mem = pm.get("copyMem", False, bool)
        self.multi_thread = pm.get("multiThread", False, bool)
        self.thread_qty = pm.get("threadQty", 0, int)
        self.chunk = pm.get("chunkSize", 0, int)
        self.precision = pm.get("precision", "float32", str)
        # pass-1 precision tier of the two-pass scan, certified exact at
        # every tier (see _knn_device_twopass)
        self.pass1_precision = pm.get("pass1Precision", "float32", str)
        if self.pass1_precision not in ("float32", "high", "bfloat16"):
            raise ValueError(f"bad pass1Precision {self.pass1_precision!r}")
        pm.check_unused()
        #: route of the last knn call: "twopass" or "single" (a diagnostic)
        self.last_route = None
        #: certified fraction of the last knn call's queries (1.0 when no
        #: certificate ran) and the 256-query blocks it re-ran in f32
        self.last_certified = 1.0
        self.last_redone_blocks = 0

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        n = max(len(store), 1)
        default = getattr(self.space, "preferred_chunk", self.DEFAULT_CHUNK)
        chunk = self.chunk or min(default, round_up(n, 8))
        chunk = round_up(chunk, 8)
        self.data = self.space.encode_dataset(store, row_multiple=chunk)
        self._chunk = chunk

    def set_query_time_params(self, params: Params | None) -> None:
        pm = ParamManager(Params.of(params))
        pm.get("dummyParam", 0, int)  # parity no-op
        pm.check_unused()
        super().set_query_time_params(params)

    def _plan_knn(self, k: int):
        n_pad = self.data.ids.shape[0]
        kk = min(k, n_pad)
        # the two-pass group-min path pays off once the corpus dwarfs the
        # (k+margin)*128 candidate re-scan; small corpora keep the
        # single-pass merge
        use_twopass = (
            self._chunk % 128 == 0
            and n_pad % 128 == 0
            and n_pad >= 8 * (kk + 2) * 128
        )
        if use_twopass and self.pass1_precision != "float32":
            # lazy certificate metadata (the f32 default never reads it)
            ensure_cert_metadata(self.data)
        return kk, use_twopass

    def knn(self, points, k: int):
        if self.data is None:
            raise IndexNotBuiltError("seq_search: index not built")
        kk, use_twopass = self._plan_knn(k)
        qenc = self.space.encode_queries(points)
        ok, redone = 1.0, 0
        if use_twopass:
            d, ids, _, ok, redone = _knn_device_twopass(
                self.space, qenc, self.data, kk, self.precision, self.pass1_precision
            )
        else:
            d, ids, _ = _knn_device(self.space, qenc, self.data, kk, self._chunk, self.precision)
        self.last_route = "twopass" if use_twopass else "single"
        out = self._knn_finish(d, ids, k, kk)
        self.last_certified, self.last_redone_blocks = float(ok), redone
        return out

    def _knn_finish(self, d, ids, k: int, kk: int):
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        if kk < k:  # keep the requested width; extras are masked
            padw = k - kk
            d = np.pad(d, ((0, 0), (0, padw)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, padw)), constant_values=-1)
        self.dist_comps += d.shape[0] * self.data.count
        return self._finalize_knn(d, ids)

    def range(self, points, radius: float):
        """Exact range search, streamed: a count pass sizes the result cap,
        a second pass keeps a running smallest-``cap`` per query, so device
        memory is O(Q * (cap + chunk)), never [Q, N] (tpu_knn's
        SeqSearch.range; reference seqsearch.cc:109-141)."""
        if self.data is None:
            raise IndexNotBuiltError("seq_search: index not built")
        qenc = self.space.encode_queries(points)
        radius = float(radius)
        counts = _range_counts_device(
            self.space, qenc, self.data, radius, self._chunk, self.precision
        ).cpu().numpy()
        self.dist_comps += counts.shape[0] * self.data.count
        return stream_range_results(
            counts,
            self.data,
            lambda cap: _range_collect_device(
                self.space, qenc, self.data, radius, cap, self._chunk, self.precision
            ),
        )

    # -- the gold-standard hook (gold_standard.h analog) --
    def exact_knn(self, points, k: int):
        return self.knn(points, k)
