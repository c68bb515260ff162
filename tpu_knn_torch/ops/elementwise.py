"""The spaces with no affine form: fused elementwise distance with a
128-row group-min epilogue, a distance epilogue or a batched epilogue.

Counterpart of what XLA fuses in tpu_knn's ``pass1_jnp``
(tpu_knn/methods/seq_search.py:233, a ``lax.scan`` of
``elementwise_blocked`` blocks, tpu_knn/ops/distance.py:205, each reduced
to its 128-row group mins), in its single-pass and range scans of the
same spaces and in every ``space.block`` of them, vmapped or not. On a
CUDA tensor each wrapper launches the hand-written
kernel of ``csrc/groupmin_elementwise.cu`` on the current stream; on a CPU
tensor it runs the plain PyTorch version, which is also what the kernel is
held against on the card:

  ========== ============================================ ================
  form       plain version (ops/distance.py)              spaces
  ========== ============================================ ================
  ``l1``     ``l1_blocked``                               l1, dummy
  ``linf``   ``linf_blocked``                             linf
  ``lp``     ``lp_blocked`` (``p`` > 0, not 1, 2 or inf)  lp
  ``js``     ``js_div_blocked``                           the JS divergences
  ``jsmetr`` sqrt(max(``js_div_blocked``, 0))             the JS metrics
  ========== ============================================ ================

Every epilogue adds ``pad`` (0, or 1e30 on padding rows) to each
distance: :func:`elementwise_groupmin` returns the group mins f32[Q, N/128]
(pass 1, one launch over the whole corpus), :func:`elementwise_dists` the
distances f32[Q, N] (one launch a corpus slice: the spaces' ``block``),
:func:`elementwise_batched` the distances f32[B, Cq, K] of each batch
item's Cq queries against its own K rows (one launch a batch: the spaces'
``gathered_block``, Cq = 1, for pass 2 and the beam, and ``pair_block``,
Cq = C, for the construction heuristic's pairs: at Cq > 1 a kernel of its
own, register tiles of C x C sums, tiled by ``csrc/pair_tiling.h`` from Cq
and K and reported by :func:`batched_geometry`). ``lp`` at a ``p`` of
:data:`LP_POWERS` runs an instance of its own, a product chain; at any
other ``p`` it runs ex2(p lg2 |a - b|) on the card's special-function unit
(:func:`lp_power` picks). The source is built with the group-min kernels
(ops/groupmin.py ``SOURCES``, ``build_all``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import distance as D
from . import groupmin as GM

GROUP = GM.GROUP
LIB = "groupmin_elementwise"
#: the kernel's forms, in its numbering; ops/groupmin.py's ``launches``
#: counts each as ``elementwise_{epilogue}_{kernel form}``
KERNEL_FORMS = ("l1", "linf", "lp", "js")
#: the kernel's epilogues, as ``launches`` names them
EPILOGUES = ("groupmin", "dists", "batched")
#: every form a space may name -> (kernel form, sqrt post)
FORMS = {"l1": (0, False), "linf": (1, False), "lp": (2, False), "js": (3, False), "jsmetr": (3, True)}
#: D multiple the kernel takes: the caller appends zero columns up to it
#: (the dense spaces pad D to 128)
D_MULTIPLE = 8
#: LP's integer powers with a kernel instance of their own, a product chain
#: (csrc's ``TK_LP_POWERS``); every other p takes the MUFU route
LP_POWERS = (3, 4, 5, 6, 7, 8)
#: the batched epilogue's tiling as ``tk_elementwise_batched_geometry`` reports it: the gathered
#: kernel's (Cq = 1) and the pair kernel's (Cq > 1; csrc/pair_tiling.h ``put_pair_tiling``)
GATHERED_GEOMETRY = ("rows_a_warp", "rows_a_block", "columns_a_step")
PAIR_GEOMETRY = ("ny", "nx", "g", "qt", "rt", "threads", "smem", "tq", "tr", "bk")


def lp_power(p: float | None) -> int:
    """The kernel's route for ``lp`` at ``p``: the integer power of its
    product chain (one of :data:`LP_POWERS`), or 0 for ex2(p lg2 |a - b|)
    (and for no ``p``)."""
    return int(p) if p is not None and float(p) in LP_POWERS else 0


def instance(form: str, p: float | None = None) -> str:
    """The name of the kernel instance that runs ``form`` (at ``p``):
    its kernel form, with the power of an LP product chain ("lp3")."""
    kf = kernel_form(form)
    power = lp_power(p) if kf == "lp" else 0
    return f"{kf}{power}" if power else kf


def kernel_form(form: str) -> str:
    """The kernel form a space's form runs ("jsmetr" runs "js")."""
    return KERNEL_FORMS[FORMS[form][0]]


def launch_key(epilogue: str, form: str) -> str:
    """The key of ops/groupmin.py's ``launches`` that counts ``form``'s
    launches of ``epilogue`` (one of :data:`EPILOGUES`)."""
    return f"elementwise_{epilogue}_{kernel_form(form)}"


def distances(form: str, q: torch.Tensor, x: torch.Tensor, p: float | None = None) -> torch.Tensor:
    """The plain distances f32[Q, N] of ``form`` (no padding term), the
    arithmetic every plain version of the kernel shares."""
    if form == "l1":
        return D.l1_blocked(q, x)
    if form == "linf":
        return D.linf_blocked(q, x)
    if form == "lp":
        return D.lp_blocked(q, x, p)
    if form not in ("js", "jsmetr"):
        raise ValueError(f"unknown elementwise form {form!r}; known: {list(FORMS)}")
    d = D.js_div_blocked(q, x)
    return torch.sqrt(torch.clamp_min(d, 0.0)) if form == "jsmetr" else d


def elementwise_dists_reference(form, q, x, pad, p=None) -> torch.Tensor:
    """Plain version of the distance epilogue: :func:`distances` + pad."""
    return distances(form, q, x, p) + pad[None, :]


def elementwise_groupmin_reference(form, q, x, pad, p=None, chunk_bytes: int = 1 << 28) -> torch.Tensor:
    """Plain version of the group-min epilogue: the distance epilogue's
    plain version per corpus chunk, then ``reshape(...).amin(2)``. Chunks
    keep the [Q, chunk] block under ``chunk_bytes``."""
    qn, n = q.shape[0], x.shape[0]
    step = max(GROUP, (chunk_bytes // (max(qn, 1) * 4)) // GROUP * GROUP)
    outs = []
    for s in range(0, n, step):
        e = min(s + step, n)
        dd = elementwise_dists_reference(form, q, x[s:e], pad[s:e], p)
        outs.append(dd.view(qn, (e - s) // GROUP, GROUP).amin(dim=2))
    return torch.cat(outs, dim=1) if outs else q.new_empty((qn, 0))


def elementwise_batched_reference(form, q, rows, pad, p=None) -> torch.Tensor:
    """Plain version of the batched epilogue: :func:`distances` of each
    batch item's queries against its own rows, ``torch.vmap``-ped over the
    batch (tpu_knn's ``jax.vmap`` of ``space.block``) in blocks of at most
    ``block_elems`` [B', Cq, K, D] elements, + pad."""
    nb, cq, d = q.shape
    k = rows.shape[1]
    if nb * cq * k == 0:
        return q.new_zeros((nb, cq, k))
    fn = torch.vmap(lambda qq, xx: distances(form, qq, xx, p))
    step = max(1, D.block_elems(q.device) // (cq * k * max(d, 1)))
    outs = [fn(q[s:s + step], rows[s:s + step]) for s in range(0, nb, step)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs)) + pad[:, None, :]


def _check_contract(fn: str, form: str, q, x, pad, p, epilogue: str) -> None:
    if form not in FORMS:
        raise ValueError(f"{fn}: unknown form {form!r}; known: {list(FORMS)}")
    if epilogue == "batched":
        if (q.ndim != 3 or x.ndim != 3 or q.shape[0] != x.shape[0] or q.shape[2] != x.shape[2]
                or pad.shape != x.shape[:2]):
            raise ValueError(f"{fn} needs q [B, Cq, D], rows [B, K, D] and pad [B, K]; got "
                             f"{tuple(q.shape)}, {tuple(x.shape)}, {tuple(pad.shape)}")
    elif q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1] or pad.shape != (x.shape[0],):
        raise ValueError(f"{fn} needs q [Q, D], x [N, D] and pad [N]; got "
                         f"{tuple(q.shape)}, {tuple(x.shape)}, {tuple(pad.shape)}")
    for name, t in (("q", q), ("x", x), ("pad", pad)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be float32 on {q.device}; got {t.dtype} on {t.device}")
    if epilogue == "groupmin" and x.shape[0] % GROUP:
        raise ValueError(f"{fn} needs n % {GROUP} == 0; got n={x.shape[0]}")
    if form == "lp" and not (p is not None and p > 0):
        raise ValueError(f"{fn}: form 'lp' needs p > 0; got {p!r}")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built by ops/groupmin.py), its entries typed, once."""
    lib = GM._load(LIB)
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.tk_elementwise.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, i64, i64,
                                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, vp]
    lib.tk_elementwise.restype = ctypes.c_int
    lib.tk_elementwise_geometry.argtypes = [ctypes.c_int, ctypes.c_int, ip]
    lib.tk_elementwise_geometry.restype = ctypes.c_int
    lib.tk_elementwise_batched.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, i64, ctypes.c_int, i64,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, vp]
    lib.tk_elementwise_batched.restype = ctypes.c_int
    lib.tk_elementwise_batched_geometry.argtypes = [ctypes.c_int, ctypes.c_int, i64, ip]
    lib.tk_elementwise_batched_geometry.restype = ctypes.c_int
    return lib


def geometry(form: str, p: float | None = None) -> dict:
    """The kernel's tiling of ``form`` (at ``p``) on the card: queries and
    rows a thread, k steps in one pass of the inner loop, queries a block."""
    out = (ctypes.c_int * 4)()
    power = lp_power(p) if kernel_form(form) == "lp" else 0
    err = _lib().tk_elementwise_geometry(FORMS[form][0], power, out)
    if err != 0:
        raise RuntimeError(f"groupmin_elementwise: no geometry for form {form!r} at p={p!r} ({err})")
    return dict(zip(("tq", "tr", "ku", "bq"), out))


def geometry_dict(cq: int, k: int, out) -> dict:
    """The batched epilogue's tiling at ``cq`` queries against ``k`` rows an item from the ints
    ``tk_elementwise_batched_geometry`` wrote: the gathered kernel's :data:`GATHERED_GEOMETRY`
    (Cq = 1), or the pair kernel's :data:`PAIR_GEOMETRY` with ``real``, the share of the pairs
    its blocks' computing warps take that are real (padding and a last warp's idle lanes are
    not)."""
    if cq == 1:
        return {"kernel": "gathered", **dict(zip(GATHERED_GEOMETRY, out))}
    t = dict(zip(PAIR_GEOMETRY, out))
    warps = -(-t["g"] * t["ny"] * t["nx"] // 32)
    computed = t["qt"] * t["rt"] * warps * 32 / t["g"] * t["tq"] * t["tr"]
    return {"kernel": "pairs", **t, "real": cq * k / computed}


def batched_geometry(cq: int, k: int | None = None, form: str = "l1") -> dict:
    """The batched epilogue's tiling on the card, as the library picks it, for ``cq`` queries
    against ``k`` rows a batch item (``k`` = ``cq`` by default) of ``form``: see
    :func:`geometry_dict`."""
    k = cq if k is None else int(k)
    if cq < 1 or k < 1:
        raise ValueError(f"batched_geometry: needs cq and k >= 1; got {cq}, {k}")
    out = (ctypes.c_int * len(PAIR_GEOMETRY))()
    err = _lib().tk_elementwise_batched_geometry(FORMS[form][0], int(cq), k, out)
    if err != 0:
        raise RuntimeError(f"groupmin_elementwise: no batched geometry at cq={cq}, k={k} ({err})")
    return geometry_dict(int(cq), k, out)


def _launch(epilogue: str, form: str, q, x, pad, p) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor; raises if it is refused."""
    for name, t in (("q", q), ("x", x), ("pad", pad)):
        if not t.is_contiguous():
            raise ValueError(f"elementwise_{epilogue}: {name} must be contiguous")
    d = q.shape[-1]
    if d % D_MULTIPLE or d == 0:  # a copy here would copy the corpus every batch
        raise ValueError(f"elementwise_{epilogue}: the kernel needs D a positive multiple of {D_MULTIPLE}; got "
                         f"D={d} (append zero columns to q and x once: they change no distance of any form)")
    for name, t in (("q", q), ("x", x)):
        if t.data_ptr() % 16:  # the kernel loads 16-byte vectors
            raise ValueError(f"elementwise_{epilogue}: {name} is not 16-byte aligned")
    if epilogue == "batched":  # q [B, Cq, D], x [B, K, D]
        shape = (q.shape[0], q.shape[1], x.shape[1])
    else:
        shape = (q.shape[0], x.shape[0] // GROUP if epilogue == "groupmin" else x.shape[0])
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0 or x.numel() == 0:
        return out
    kform, sqrt_post = FORMS[form]
    pf = float(p) if form == "lp" else 0.0
    tail = (pf, 1.0 / pf if pf else 0.0, int(sqrt_post))
    lib = _lib()
    ptrs = (q.data_ptr(), x.data_ptr(), pad.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if epilogue == "batched":
            err = lib.tk_elementwise_batched(kform, lp_power(pf), *ptrs, *shape, d, *tail, stream)
        else:
            err = lib.tk_elementwise(kform, lp_power(pf), int(epilogue == "groupmin"), *ptrs, *shape[:1],
                                     x.shape[0], d, *tail, stream)
    if err != 0:
        msg = lib.tk_error_string(err).decode()
        raise RuntimeError(f"groupmin_elementwise {epilogue} {form} kernel launch failed: {msg} ({err})")
    GM.count_launch(launch_key(epilogue, form))
    return out


def elementwise_groupmin(form: str, q, x, pad, p=None) -> torch.Tensor:
    """Group mins f32[Q, N/128] of ``form``'s distances plus ``pad``.

    A CPU tensor runs :func:`elementwise_groupmin_reference`. A CUDA tensor
    launches the kernel or raises; it never falls back."""
    _check_contract("elementwise_groupmin", form, q, x, pad, p, "groupmin")
    if q.device.type == "cpu":
        return elementwise_groupmin_reference(form, q, x, pad, p)
    if q.device.type != "cuda":
        raise ValueError(f"elementwise_groupmin: unsupported device {q.device}")
    return _launch("groupmin", form, q, x, pad, p)


def elementwise_dists(form: str, q, x, pad, p=None) -> torch.Tensor:
    """Distances f32[Q, N] of ``form`` plus ``pad``, for one corpus slice.

    A CPU tensor runs :func:`elementwise_dists_reference`. A CUDA tensor
    launches the kernel or raises; it never falls back."""
    _check_contract("elementwise_dists", form, q, x, pad, p, "dists")
    if q.device.type == "cpu":
        return elementwise_dists_reference(form, q, x, pad, p)
    if q.device.type != "cuda":
        raise ValueError(f"elementwise_dists: unsupported device {q.device}")
    return _launch("dists", form, q, x, pad, p)


def elementwise_batched(form: str, q, rows, pad, p=None) -> torch.Tensor:
    """Distances f32[B, Cq, K] of ``form`` plus ``pad``: batch item b's Cq
    queries ``q[b]`` against its own K rows ``rows[b]``.

    A CPU tensor runs :func:`elementwise_batched_reference`. A CUDA tensor
    launches the kernel or raises; it never falls back."""
    _check_contract("elementwise_batched", form, q, rows, pad, p, "batched")
    if q.device.type == "cpu":
        return elementwise_batched_reference(form, q, rows, pad, p)
    if q.device.type != "cuda":
        raise ValueError(f"elementwise_batched: unsupported device {q.device}")
    return _launch("batched", form, q, rows, pad, p)
