"""Dense vector spaces, matmul-factored where they can be (counterpart of
tpu_knn/spaces/dense.py).

Every space tpu_knn registers here: the Lp family ``l2``/``l1``/``linf``/
``lp`` (space_lp.h:49-67, distcomp_lp.cc), the scalar-product family
``cosinesimil``/``angulardist``/``negdotprod`` (space_scalar.h,
distcomp_scalar.cc), the Bregman divergences KL / generalized KL /
Itakura-Saito with their "rq" reversed-argument variants (space_bregman.h,
distcomp_bregman.cc), Jensen-Shannon divergence and metric (space_js.h,
distcomp_js.cc), the alpha-beta and Renyi divergences
(space_ab_diverg.h, space_renyi_diverg.h), the uint8 SIFT integer-L2^2
space ``l2sqr_sift`` (space_l2sqr_sift.h, distcomp_l2sqr_sift.cc) and
``dummy`` (space_dummy.h); and the certificate metadata of the reduced
pass-1 tiers (:func:`ensure_cert_metadata`). Where the reference stores
precomputed logs/norms inside each Object's byte buffer, the whole
transformed corpus matrix and its per-row terms are precomputed at encode
time so every factored distance block is one matmul (ops/distance.py).

The element transforms (``_transform_x``/``_transform_q``) are host
numpy, as in tpu_knn, so encoded rows are bit-equal to its. The per-row
terms (``_term_x``/``_term_q``) are taken on the device from the raw rows
as a tensor: f32 sums in torch's order, not numpy's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore, DenseDeviceData, DistKind, round_up
from ..core.errors import InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_space
from ..ops import distance as D
from ..ops import elementwise as E
from ..utils import tracing
from .base import Space

#: Large-but-finite mask value for padded corpus rows (kept finite so that
#: post-transforms like sqrt stay NaN-free).
PAD_TERM = 1e30

_TINY = 1e-30


def clear_upload_cache() -> int:
    """API parity with tpu_knn: the port keeps no content-keyed upload
    cache (each index owns its tensors), so there is nothing to release.
    Returns the number of entries dropped: always 0."""
    return 0


def ensure_cert_metadata(data) -> None:
    """Certificate metadata for the reduced-precision pass-1 scan
    (methods/seq_search.py _pass1_eps), computed lazily on first use and
    cached in ``data.extra`` as 0-d f32 tensors: the max squared row norm
    of the stored matrix and the exactly computed bf16 rounding residual
    norms, |x - bf16(x)| per row and the second level |lo - bf16(lo)|.
    1.01 headroom covers the f32 reductions. Padding rows are zero and
    cannot raise the maxima. int8 data is skipped: its pass 1 is exact."""
    if "max_lo_norm" in data.extra or data.count == 0 or data.vecs.dtype == torch.int8:
        return
    x = data.vecs.float()
    data.extra["max_sq_norm"] = torch.max(torch.sum(x * x, dim=1)) * 1.01
    lo = x - x.to(torch.bfloat16).float()
    data.extra["max_lo_norm"] = torch.sqrt(torch.max(torch.sum(lo * lo, dim=1))) * 1.01
    ble = lo - lo.to(torch.bfloat16).float()
    data.extra["max_blo_err"] = torch.sqrt(torch.max(torch.sum(ble * ble, dim=1))) * 1.01


def _pad_ids(ids: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad the object-id vector with -1 so padding rows are recognizable."""
    if ids.shape[0] == n_pad:
        return ids
    return np.concatenate([ids, np.full(n_pad - ids.shape[0], -1, dtype=ids.dtype)])


def _pad_cols(a: np.ndarray, mult: int = 128) -> np.ndarray:
    d = a.shape[1]
    dp = round_up(max(d, 1), mult)
    if dp == d:
        return a
    return np.concatenate([a, np.zeros((a.shape[0], dp - d), dtype=a.dtype)], axis=1)


class DenseSpace(Space):
    """Shared encode/slice machinery for dense float spaces.

    Subclasses define ``_transform_x/_transform_q`` (element transforms),
    ``_term_x/_term_q`` (per-row scalar terms) and ``_block_impl``; a space
    with an elementwise form (``pass1_elementwise``) scores through
    ops/elementwise.py instead: ``block`` with the kernel's distance
    epilogue, ``gathered_block`` and ``pair_block`` with its batched
    epilogue, one launch each on the card.
    """

    data_kind = DataKind.DENSE

    # --- hooks ---
    def _transform_x(self, v: np.ndarray) -> np.ndarray:
        return v

    def _transform_q(self, v: np.ndarray) -> np.ndarray:
        return v

    def _term_x(self, v: torch.Tensor):
        return None

    def _term_q(self, v: torch.Tensor):
        return None

    def _block_impl(self, qenc: dict, xc: dict, precision: str) -> torch.Tensor:
        raise NotImplementedError

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # --- Space interface ---
    def encode_dataset(self, store: DataStore, row_multiple: int = 8) -> DenseDeviceData:
        with tracing.span("spaces.pack"):
            mat = store.dense_matrix().astype(np.float32)
        n, dim = mat.shape
        n_pad = round_up(max(n, 1), row_multiple)
        xt = _pad_cols(self._transform_x(mat).astype(np.float32))
        vecs = torch.zeros((n_pad, xt.shape[1]), dtype=torch.float32, device=self.device)
        vecs[:n] = self._upload(xt)
        # the per-row term from the device matrix where it is a function of
        # the stored row (term_from_rows), else from the host rows
        row_term = self.term_from_rows(vecs)
        if row_term is None:
            term = self._term_x(self._upload(mat))
            if term is not None:
                row_term = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
                row_term[:n] = term
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = _pad_ids(np.asarray(store.ids, np.int32).reshape(-1), n_pad)
        data = DenseDeviceData(
            vecs=vecs,
            ids=self._upload(ids),
            count=n,
            dim=dim,
            row_term=row_term,
        )
        data.extra["pad"] = self._upload(pad)
        return data

    def encode_queries(self, points) -> dict:
        q = np.asarray(points, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        enc = {"q": self._upload(_pad_cols(self._transform_q(q).astype(np.float32)))}
        term = self._term_q(self._upload(q))
        if term is not None:
            enc["q_term"] = term.to(torch.float32)
        return enc

    def slice_data(self, data: DenseDeviceData, start: int, size: int) -> dict:
        xc = {"x": data.vecs[start:start + size], "pad": data.extra["pad"][start:start + size]}
        if data.row_term is not None:
            xc["x_term"] = data.row_term[start:start + size]
        for k, v in data.extra.items():
            # per-row tensors only; 0-d entries are metadata
            if k != "pad" and getattr(v, "ndim", 0) >= 1:
                xc[k] = v[start:start + size]
        return xc

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        ew = self.pass1_elementwise()
        if ew is not None:  # the kernel adds the pad
            return E.elementwise_dists(ew[0], qenc["q"].contiguous(), xc["x"], xc["pad"], ew[1])
        d = self._block_impl(qenc, xc, precision)
        return d + xc["pad"][None, :]

    # ops/graph.score_gathered and methods/hnsw._score_pairs take these
    # scorers where a space has them; None leaves them their own routes

    @property
    def gathered_block(self):
        """Distances f32[B, K] of query b to its own gathered rows [B, K, D]
        with pad [B, K], for an elementwise space; else None."""
        return None if self.pass1_elementwise() is None else self._gathered_elementwise

    @property
    def pair_block(self):
        """Distances f32[B, C, C2] of per-row candidate encodings 'q'
        [B, C, D] to gathered rows [B, C2, D] with pad [B, C2], for an
        elementwise space; else None."""
        return None if self.pass1_elementwise() is None else self._pair_elementwise

    def _gathered_elementwise(self, qenc, rows, pad, extra) -> torch.Tensor:
        form, p = self.pass1_elementwise()
        return E.elementwise_batched(form, qenc["q"].contiguous()[:, None, :], rows, pad, p)[:, 0, :]

    def _pair_elementwise(self, qe, rows, pad, extra, v_pad=None) -> torch.Tensor:
        form, p = self.pass1_elementwise()
        return E.elementwise_batched(form, qe["q"].contiguous(), rows, pad, p)


# ---------------- Lp family ----------------


class LpSpaceBase(DenseSpace):
    """Lp norms (reference: space_lp.h:49-67, distcomp_lp.cc). p == 2 goes
    through the matmul norm identity; p in {1, inf} and generic p are
    elementwise forms with no affine one (DenseSpace's kernel scorers)."""

    def __init__(self, params: Params | None = None, p: float = 2.0, device="cpu"):
        super().__init__(params, device)
        self.p = float(p)
        self.term_recompute = self.p == 2.0

    def _term_q(self, v):
        return D.sq_norms(v) if self.p == 2.0 else None

    def pass1_affine(self):
        return (-2.0, 1.0, 1.0) if self.p == 2.0 else None

    def pass1_elementwise(self):
        if self.p == 2.0:
            return None
        if self.p == 1.0:
            return ("l1", None)
        return ("linf", None) if math.isinf(self.p) else ("lp", self.p)

    def pass1_post(self, s, qenc):
        return torch.sqrt(torch.clamp_min(s, 0.0))

    def term_from_rows(self, rows):
        return torch.sum(rows * rows, dim=-1) if self.p == 2.0 else None

    def rows_as_queries(self, rows):
        # _transform_x == _transform_q == identity for p=2: a corpus row
        # IS its own query encoding (term recomputed from the row)
        if self.p != 2.0:
            return None
        return {"q": rows, "q_term": torch.sum(rows * rows, dim=-1)}

    def _block_impl(self, qenc, xc, precision):  # p == 2; the others are elementwise
        d2 = D.factored(qenc["q"], xc["x"], qenc["q_term"], xc["x_term"], scale=-2.0, precision=precision)
        return torch.sqrt(torch.clamp_min(d2, 0.0))


@register_space("l2")
class L2Space(LpSpaceBase):
    name = "l2"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, p=2.0, device=device)


@register_space("l1")
class L1Space(LpSpaceBase):
    name = "l1"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, p=1.0, device=device)


@register_space("linf")
class LinfSpace(LpSpaceBase):
    name = "linf"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, p=math.inf, device=device)


@register_space("lp")
class LpSpace(LpSpaceBase):
    name = "lp"

    def __init__(self, params=None, device="cpu"):
        pm = ParamManager(params)
        p = pm.get("p", 2.0, float)
        pm.check_unused()
        if p <= 0:
            raise InvalidArgumentError("lp requires p > 0")
        super().__init__(params, p=p, device=device)


# ---------------- scalar-product family ----------------


def _normalize_rows(v: np.ndarray) -> np.ndarray:
    """Unit rows, on the host in numpy exactly as tpu_knn computes them (so
    encodes are bit-equal); zero rows stay zero."""
    n = np.linalg.norm(v, axis=1, keepdims=True)
    return np.where(n > 0, v / np.maximum(n, _TINY), v)


class _NormalizedDotSpace(DenseSpace):
    """Rows normalized at encode (the reference's HNSW optimization,
    hnsw.cc:441-446, applied universally); the affine surrogate of pass 1
    is -qn.xn with no row terms."""

    def pass1_affine(self):
        return (-1.0, 0.0, 0.0)

    def rows_as_queries(self, rows):
        # corpus rows are pre-normalized at encode; normalizing again is
        # the identity, so a row is its own query encoding
        return {"q": rows}

    def _transform_x(self, v):
        return _normalize_rows(v)

    def _transform_q(self, v):
        return _normalize_rows(v)


@register_space("cosinesimil")
class CosineSpace(_NormalizedDotSpace):
    """1 - cos."""

    name = "cosinesimil"

    def pass1_post(self, s, qenc):
        return torch.clamp_min(1.0 + s, 0.0)

    def _block_impl(self, qenc, xc, precision):
        return D.cosine_blocked(qenc["q"], xc["x"], precision)


@register_space("angulardist")
class AngularSpace(_NormalizedDotSpace):
    """arccos(cos), the cosine clipped to [-1, 1]."""

    name = "angulardist"

    def pass1_post(self, s, qenc):
        return torch.arccos(torch.clamp(-s, -1.0, 1.0))

    def _block_impl(self, qenc, xc, precision):
        return D.angular_blocked(qenc["q"], xc["x"], precision)


@register_space("negdotprod")
class NegDotProdSpace(DenseSpace):
    """-<q, x> on the raw rows."""

    name = "negdotprod"

    def pass1_affine(self):
        return (-1.0, 0.0, 0.0)

    def rows_as_queries(self, rows):
        return {"q": rows}  # both transforms are the identity

    def _block_impl(self, qenc, xc, precision):
        return D.negdot_blocked(qenc["q"], xc["x"], precision)


# ---------------- Bregman divergences ----------------


def _safe_log(v: np.ndarray) -> np.ndarray:
    return np.log(np.maximum(v, _TINY))


def _safe_log_t(v: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(v, _TINY))


class KLDivSpace(DenseSpace):
    """KL divergence family (reference: space_bregman.h,
    distcomp_bregman.cc). ``generalized`` adds the (-sum q + sum x) terms
    of the generalized KL; ``reversed`` ("rq") computes KL(x||q)."""

    def __init__(self, params=None, device="cpu", generalized=False, reversed_=False):
        super().__init__(params, device)
        self.generalized = generalized
        self.reversed = reversed_

    def _transform_x(self, v):
        return v if self.reversed else _safe_log(v)

    def _transform_q(self, v):
        return _safe_log(v) if self.reversed else v

    def _xlogx_term(self, v):
        """sum v log v (generalized: - sum v)."""
        t = torch.sum(v * _safe_log_t(v), dim=1)
        return t - torch.sum(v, dim=1) if self.generalized else t

    def _term_x(self, v):
        if self.reversed:
            return self._xlogx_term(v)
        return torch.sum(v, dim=1) if self.generalized else None

    def _term_q(self, v):
        if self.reversed:
            return torch.sum(v, dim=1) if self.generalized else None
        return self._xlogx_term(v)

    def pass1_affine(self):
        return (-1.0, 1.0, 1.0)

    def _block_impl(self, qenc, xc, precision):
        d = -D.matmul(qenc["q"], xc["x"], precision)  # q . log x  (or log q . x)
        if "q_term" in qenc:
            d = d + qenc["q_term"][:, None]
        if "x_term" in xc:
            d = d + xc["x_term"][None, :]
        return d


@register_space("kldivfast")
class KLDivFast(KLDivSpace):
    name = "kldivfast"


@register_space("kldivfastrq")
class KLDivFastRQ(KLDivSpace):
    name = "kldivfastrq"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, device, reversed_=True)


@register_space("kldivgenfast")
class KLDivGenFast(KLDivSpace):
    name = "kldivgenfast"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, device, generalized=True)


@register_space("kldivgenfastrq")
class KLDivGenFastRQ(KLDivSpace):
    name = "kldivgenfastrq"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, device, generalized=True, reversed_=True)


@register_space("kldivgenslow")
class KLDivGenSlow(KLDivSpace):
    name = "kldivgenslow"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, device, generalized=True)


class ItakuraSaitoSpace(DenseSpace):
    """IS(q,x) = q.(1/x) - sum log q + sum log x - d."""

    def __init__(self, params=None, device="cpu", reversed_=False):
        super().__init__(params, device)
        self.reversed = reversed_

    def _transform_x(self, v):
        return v if self.reversed else 1.0 / np.maximum(v, _TINY)

    def _transform_q(self, v):
        return 1.0 / np.maximum(v, _TINY) if self.reversed else v

    def _term_x(self, v):
        s = torch.sum(_safe_log_t(v), dim=1)
        return -s if self.reversed else s

    def _term_q(self, v):
        s = torch.sum(_safe_log_t(v), dim=1)
        return s if self.reversed else -s

    def pass1_affine(self):
        return (1.0, 1.0, 1.0)

    def pass1_post(self, s, qenc):
        return s - qenc["_dim"]

    def _block_impl(self, qenc, xc, precision):
        g = D.matmul(qenc["q"], xc["x"], precision)
        return g + qenc["q_term"][:, None] + xc["x_term"][None, :] - qenc["_dim"]

    def encode_queries(self, points):
        enc = super().encode_queries(points)
        d = np.asarray(points)
        dim = d.shape[-1] if d.ndim > 1 else d.shape[0]
        enc["_dim"] = torch.tensor(float(dim), dtype=torch.float32, device=self.device)
        return enc


@register_space("itakurasaitofast")
class ISFast(ItakuraSaitoSpace):
    name = "itakurasaitofast"


@register_space("itakurasaitoslow")
class ISSlow(ItakuraSaitoSpace):
    name = "itakurasaitoslow"


@register_space("itakurasaitofastrq")
class ISFastRQ(ItakuraSaitoSpace):
    name = "itakurasaitofastrq"

    def __init__(self, params=None, device="cpu"):
        super().__init__(params, device, reversed_=True)


# ---------------- Jensen-Shannon ----------------


class JSDivSpace(DenseSpace):
    """JS divergence, an elementwise form (not matmul-factorable because of
    log(q+x); reference: distcomp_js.cc)."""

    def pass1_elementwise(self):
        return ("js", None)


@register_space("jsdivslow")  # C++ registry spelling (space_js.h:29)
@register_space("js_div_slow")  # Zig-whitelist spelling (lib.zig)
class JSDivSlow(JSDivSpace):
    name = "js_div_slow"


@register_space("jsdivfast")  # C++ registry spelling (space_js.h:30)
@register_space("js_div_fast")
class JSDivFast(JSDivSpace):
    name = "js_div_fast"


@register_space("jsdivfastapprox")  # C++ registry spelling (space_js.h:31)
@register_space("js_div_fast_approx")
class JSDivFastApprox(JSDivSpace):
    name = "js_div_fast_approx"


class JSMetricSpace(JSDivSpace):
    """JS *metric* = sqrt(JS divergence) (reference: space_js.h kJSFast*
    metric variants, init_spaces.h:69-71; registered but absent from the
    Zig whitelist)."""

    def pass1_elementwise(self):
        return ("jsmetr", None)


@register_space("jsmetrslow")
class JSMetricSlow(JSMetricSpace):
    name = "jsmetrslow"


@register_space("jsmetrfast")
class JSMetricFast(JSMetricSpace):
    name = "jsmetrfast"


@register_space("jsmetrfastapprox")
class JSMetricFastApprox(JSMetricSpace):
    name = "jsmetrfastapprox"


# ---------------- alpha-beta / Renyi divergences ----------------


class AlphaBetaDivSpace(DenseSpace):
    """Alpha-beta divergence (reference: space_ab_diverg.h,
    src/distcomp_diverg.cc), alpha, beta != 0, alpha+beta != 0."""

    def __init__(self, params=None, device="cpu"):
        pm = ParamManager(params)
        self.alpha = pm.get("alpha", 1.0, float)
        self.beta = pm.get("beta", 1.0, float)
        pm.check_unused()
        if self.alpha == 0 or self.beta == 0 or self.alpha + self.beta == 0:
            raise InvalidArgumentError("abdiv requires alpha != 0, beta != 0, alpha+beta != 0")
        super().__init__(params, device)

    def _transform_x(self, v):
        return np.maximum(v, _TINY) ** self.beta

    def _transform_q(self, v):
        return np.maximum(v, _TINY) ** self.alpha

    def _term_x(self, v):
        return torch.sum(torch.clamp_min(v, _TINY) ** (self.alpha + self.beta), dim=1)

    _term_q = _term_x

    def pass1_affine(self):
        a, b = self.alpha, self.beta
        s = a + b
        return (-1.0 / (a * b), 1.0 / (s * b), 1.0 / (s * a))

    def _block_impl(self, qenc, xc, precision):
        return D.abdiv_blocked(
            qenc["q"], xc["x"], qenc["q_term"], xc["x_term"], self.alpha, self.beta, precision
        )


@register_space("abdiv_fast")
class ABDivFast(AlphaBetaDivSpace):
    name = "abdiv_fast"


@register_space("abdiv_slow")
class ABDivSlow(AlphaBetaDivSpace):
    name = "abdiv_slow"


class RenyiDivSpace(DenseSpace):
    """Renyi divergence D_a(q||x) = log(sum q^a x^(1-a)) / (a-1), a != 1."""

    def __init__(self, params=None, device="cpu"):
        pm = ParamManager(params)
        self.alpha = pm.get("alpha", 0.5, float)
        pm.check_unused()
        if self.alpha == 1.0 or self.alpha <= 0:
            raise InvalidArgumentError("renyidiv requires alpha > 0, alpha != 1")
        super().__init__(params, device)

    def _transform_x(self, v):
        return np.maximum(v, _TINY) ** (1.0 - self.alpha)

    def _transform_q(self, v):
        return np.maximum(v, _TINY) ** self.alpha

    def _block_impl(self, qenc, xc, precision):
        return D.renyi_blocked(qenc["q"], xc["x"], self.alpha, precision)


@register_space("renyidiv_fast")
class RenyiDivFast(RenyiDivSpace):
    name = "renyidiv_fast"


@register_space("renyidiv_slow")
class RenyiDivSlow(RenyiDivSpace):
    name = "renyidiv_slow"


# ---------------- uint8 SIFT integer L2^2 ----------------


@register_space("l2sqr_sift")
class L2SqrSiftSpace(DenseSpace):
    """Exact integer squared-L2 over uint8[128] descriptors (reference:
    space_l2sqr_sift.cc:136-150, distcomp_l2sqr_sift.cc:41-151).

    The u8 values shift to int8 (a = x - 128) so the dot runs on the int8
    tensor cores (the int8 group-min kernel, exact i32 accumulation). With
    sa = sum(a) per row:

        <x, y> = <a_x, a_y> + 128(sa_x + sa_y) + 16384*d
        |x-y|^2 = (|x|^2 - 256 sa_x) + (|y|^2 - 256 sa_y)
                  - 2<a_x, a_y> - 32768*d

    so the affine factored form holds with q/x terms |.|^2 - 256*sa and
    the constant -32768*d (``_dimconst``, a 0-d tensor) applied in
    pass1_post. Every quantity is an integer below 2^24, exact in f32, so
    every distance is exact."""

    name = "l2sqr_sift"
    data_kind = DataKind.UINT8
    dist_kind = DistKind.INT
    term_recompute = True

    def _dimconst(self, d: int) -> torch.Tensor:
        return torch.tensor(32768.0 * d, dtype=torch.float32, device=self.device)

    def term_from_rows(self, rows):
        # term = |x|^2 - 256*sum(a) = sum(a^2) + 16384*d, a = x - 128;
        # all integers < 2^24, bit-equal to the encode-time value
        a = rows.float()
        return torch.sum(a * a, dim=-1) + 16384.0 * rows.shape[-1]

    @staticmethod
    def _encode_mat(mat: np.ndarray):
        fm = mat.astype(np.float32)
        a = (mat.astype(np.int16) - 128).astype(np.int8)
        term = (np.sum(fm * fm, axis=1) - 256.0 * np.sum(fm - 128.0, axis=1)).astype(np.float32)
        return a, term

    def encode_dataset(self, store: DataStore, row_multiple: int = 8) -> DenseDeviceData:
        mat = store.dense_matrix()  # uint8
        if mat.shape[0] and mat.shape[1] != 128:
            raise InvalidArgumentError("l2sqr_sift requires 128-byte descriptors")
        n, dim = mat.shape if mat.ndim == 2 else (0, 128)
        n_pad = round_up(max(n, 1), row_multiple)
        a, term = self._encode_mat(mat if n else np.zeros((0, 128), np.uint8))
        # int8; padding rows are 0 and masked by the pad term
        vecs = torch.zeros((n_pad, 128), dtype=torch.int8, device=self.device)
        vecs[:n] = self._upload(a)
        row_term = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        row_term[:n] = self._upload(term)
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = _pad_ids(np.asarray(store.ids, np.int32).reshape(-1), n_pad)
        data = DenseDeviceData(
            vecs=vecs, ids=self._upload(ids), count=n, dim=max(dim, 128), row_term=row_term,
        )
        data.extra["pad"] = self._upload(pad)
        return data

    def encode_queries(self, points) -> dict:
        q = np.asarray(points, dtype=np.uint8)
        if q.ndim == 1:
            q = q[None, :]
        a, term = self._encode_mat(q)
        return {"q": self._upload(a), "q_term": self._upload(term), "_dimconst": self._dimconst(q.shape[1])}

    def pass1_affine(self):
        return (-2.0, 1.0, 1.0)

    def rows_as_queries(self, rows):
        # corpus rows are the shifted int8 descriptors; the query encode
        # applies the same shift, so rows are their own query encodings
        return {
            "q": rows,
            "q_term": self.term_from_rows(rows),
            "_dimconst": self._dimconst(rows.shape[-1]),
        }

    def pass1_post(self, s, qenc):
        return torch.clamp_min(s - qenc["_dimconst"], 0.0)

    def _block_impl(self, qenc, xc, precision):
        g = D.int8_dot(qenc["q"], xc["x"])
        d = qenc["q_term"][:, None] + xc["x_term"][None, :] - 2.0 * g - qenc["_dimconst"]
        return torch.clamp_min(d, 0.0)


# ---------------- dummy ----------------


@register_space("dummy")
class DummySpace(DenseSpace):
    """Trivial example space (reference: space_dummy.h): L1 on dense
    vectors, enough to exercise the method machinery end to end."""

    name = "dummy"

    def pass1_elementwise(self):
        return ("l1", None)
