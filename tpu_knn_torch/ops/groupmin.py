"""Pass 1 of the exact two-pass kNN scan: fused distance + 128-row group min.

Counterpart of ``tpu_knn/ops/pallas_scan.py`` (``fused_groupmin``) and of
its four precision tiers. On a CUDA tensor the wrapper launches the
tier's hand-written kernel; on a CPU tensor it runs the plain PyTorch
version, :func:`fused_groupmin_reference`, which is also what each kernel
is held against on the card:

  ========== ============================== ==================================
  tier       kernel                         dot of the plain version
  ========== ============================== ==================================
  float32    ``csrc/groupmin.cu`` (FFMA)    IEEE f32 matmul
  int8       ``csrc/groupmin_wgmma_i8.cu``  f32 matmul of the int8 values cast
             (s8 ``wgmma``, exact)          to f32: exact, so bit-equal
  high       ``csrc/groupmin_wgmma.cu``     bf16x3: hi.hi + (hi.lo + lo.hi),
             (bf16 ``wgmma``, 3 passes)     each an f32 matmul of bf16-rounded
                                            values cast back to f32
  bfloat16   ``csrc/groupmin_wgmma.cu``     hi.hi likewise
  ========== ============================== ==================================

The tier follows the input, as in the TPU kernel: int8 ``q``/``x`` run the
int8 tier whatever ``precision`` says; f32 inputs run ``precision``.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface on first use, keyed by a hash of its source, of every file the
source includes (``csrc/wgmma_common.cuh``) and of the flags, under
``tpu_knn_torch/_build/``, and loaded with ``ctypes``. :func:`build_all`
runs the nvcc processes side by side. Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

GROUP = 128
TIERS = ("float32", "int8", "high", "bfloat16")
#: tpu_knn's matmul precision names; int8 is picked by the operands' dtype
PRECISIONS = ("float32", "high", "bfloat16")

_PKG = Path(__file__).resolve().parent.parent
#: library name -> CUDA source
SOURCES = {
    "groupmin": _PKG / "csrc" / "groupmin.cu",
    "groupmin_wgmma": _PKG / "csrc" / "groupmin_wgmma.cu",
    "groupmin_wgmma_i8": _PKG / "csrc" / "groupmin_wgmma_i8.cu",
}
#: where a source's ``#include "..."`` is looked up after its own directory
INCLUDE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: tier -> (library, C entry point, D multiple the kernel needs)
_ENTRY = {
    "float32": ("groupmin", "tk_groupmin_f32", 8),
    "int8": ("groupmin_wgmma_i8", "tk_groupmin_i8", 16),
    "high": ("groupmin_wgmma", "tk_groupmin_bf16x3", 8),
    "bfloat16": ("groupmin_wgmma", "tk_groupmin_bf16", 8),
}
#: libraries whose entries also take a scratch for the query image (pointer,
#: bytes): library -> (the function that sizes it, what it takes after (nq, d))
_SCRATCH_BYTES = {
    "groupmin_wgmma": ("tk_groupmin_wgmma_scratch_bytes", (ctypes.c_int,)),  # 1 for bf16x3
    "groupmin_wgmma_i8": ("tk_groupmin_i8_scratch_bytes", ()),
}

#: kernel launches made by :func:`fused_groupmin`, per tier (CUDA tensors only)
launches = dict.fromkeys(TIERS, 0)

_libs: dict = {}
#: nvcc's output of the build that produced each loaded library ("" if cached)
build_log: dict = {}


def reset_launches() -> None:
    for tier in launches:
        launches[tier] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _with_includes(path: Path, seen: list) -> list:
    """``path`` and every file it includes with ``#include "..."``, each once,
    looked up beside the including file and then in :data:`INCLUDE_DIR`."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in re.findall(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', path.read_text(), flags=re.M):
        found = next((d / inc for d in (path.parent, INCLUDE_DIR) if (d / inc).is_file()), None)
        if found is None:
            raise RuntimeError(f"{path}: included file {inc!r} not found")
        _with_includes(found.resolve(), seen)
    return seen


def _lib_path(name: str) -> Path:
    """The library of a source: keyed by the source, every file it includes
    and the flags, so an edit to a shared header rebuilds what includes it."""
    h = hashlib.sha256()
    for f in _with_includes(SOURCES[name].resolve(), []):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=tuple(SOURCES)) -> dict:
    """Compile each named source for sm_90a unless a library built from the
    same source and flags exists, one nvcc process per source, all started
    together. Returns {name: library path}; raises with nvcc's output when
    a build fails."""
    libs = {name: _lib_path(name) for name in names}
    todo = [name for name in names if not libs[name].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".{libs[name].name}.{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}) on {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, libs[name])  # atomic: a concurrent build never loads a partial file
            build_log[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str = "groupmin") -> Path:
    """Compile one source (see :func:`build_all`); return its library's path."""
    return build_all((name,))[name]


def _load(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        args = [p, p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_float]
        if name in _SCRATCH_BYTES:
            args += [p, i64]
            fname, extra = _SCRATCH_BYTES[name]
            sizer = getattr(lib, fname)
            sizer.argtypes = [i64, ctypes.c_int, *extra]
            sizer.restype = i64
        for lname, entry, _ in _ENTRY.values():
            if lname == name:
                fn = getattr(lib, entry)
                fn.argtypes = [*args, p]
                fn.restype = ctypes.c_int
        lib.tk_error_string.argtypes = [ctypes.c_int]
        lib.tk_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def int8_plan(d: int, scale: float) -> dict:
    """The layout the int8 kernel takes at dimension ``d`` and ``scale`` on
    the current card: consumer warpgroups, 128-row groups of the resident
    corpus tile each owns, ring stages, slabs resident at once (of
    ceil(d / 128); fewer means K chunks), two corpus buffers, and the fused
    multiply-add epilogue of a power-of-two scale."""
    lib = _load("groupmin_wgmma_i8")
    out = (ctypes.c_int * 6)()
    lib.tk_groupmin_i8_plan.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int)]
    lib.tk_groupmin_i8_plan.restype = ctypes.c_int
    err = lib.tk_groupmin_i8_plan(d, float(scale), out)
    if err != 0:
        raise RuntimeError(f"groupmin int8: no kernel plan at d={d}: {lib.tk_error_string(err).decode()} ({err})")
    keys = ("warpgroups", "groups_each", "stages", "slabs_resident", "two_buffers", "pow2_scale")
    return dict(zip(keys, out))


def tier_of(q: torch.Tensor, precision: str) -> str:
    """The tier a call runs: int8 inputs run the int8 tier whatever
    ``precision`` says (as the TPU kernel does); f32 inputs run ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"fused_groupmin: unknown precision {precision!r}")
    return "int8" if q.dtype == torch.int8 else precision


def _check_contract(q, x, q_term, x_term, tier: str) -> None:
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"fused_groupmin needs q [Q, D] and x [N, D]; got {tuple(q.shape)}, {tuple(x.shape)}"
        )
    want = torch.int8 if tier == "int8" else torch.float32
    if q.dtype != want or x.dtype != want:
        raise ValueError(
            f"fused_groupmin tier {tier!r} needs q and x in {want}; got {q.dtype}, {x.dtype}"
        )
    qn, d = q.shape
    n = x.shape[0]
    dmul = _ENTRY[tier][2]
    if n % GROUP or d % dmul:
        raise ValueError(
            f"fused_groupmin tier {tier!r} needs n%{GROUP}==0 and d%{dmul}==0; got n={n} d={d}"
        )
    if q_term.shape != (qn,) or x_term.shape != (n,):
        raise ValueError(
            f"fused_groupmin needs q_term [{qn}] and x_term [{n}]; "
            f"got {tuple(q_term.shape)}, {tuple(x_term.shape)}"
        )


def _bf16_split(v: torch.Tensor):
    """hi = bf16(v) and lo = bf16(v - hi), both as f32 (round to nearest even)."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    lo = (v - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def _tier_dot(q, x, tier: str) -> torch.Tensor:
    """<q, x> [Q, C] of one tier in the working type of ``q`` (f32 or f64):
    IEEE matmuls only, never a bf16 matmul (whose output is rounded to bf16)."""
    if tier in ("float32", "int8"):
        return q @ x.T
    qh, ql = _bf16_split(q.float())
    xh, xl = _bf16_split(x.float())
    qh, ql, xh, xl = (t.to(q.dtype) for t in (qh, ql, xh, xl))
    if tier == "bfloat16":
        return qh @ xh.T
    return qh @ xh.T + (qh @ xl.T + ql @ xh.T)


def fused_groupmin_reference(q, x, q_term, x_term, scale: float, precision: str = "float32",
                             chunk_bytes: int = 1 << 28):
    """Plain PyTorch group mins [Q, N/128] of ``scale*<q,x> + x_term + q_term``:
    one :func:`_tier_dot` per corpus chunk, then a reshape-min, in
    ``q_term``'s dtype (int8 inputs are cast to it, exactly). Chunks keep
    the [Q, chunk] block under ``chunk_bytes``."""
    tier = tier_of(q, precision)
    dt = q_term.dtype
    q = q.to(dt)
    qn, n = q.shape[0], x.shape[0]
    per_row = max(qn, 1) * q.element_size()
    step = max(GROUP, (chunk_bytes // per_row) // GROUP * GROUP)
    outs = []
    for s in range(0, n, step):
        e = min(s + step, n)
        dd = scale * _tier_dot(q, x[s:e].to(dt), tier) + x_term[None, s:e] + q_term[:, None]
        outs.append(dd.view(qn, (e - s) // GROUP, GROUP).amin(dim=2))
    if not outs:
        return q.new_empty((qn, 0))
    return torch.cat(outs, dim=1)


def fused_groupmin(q, x, q_term, x_term, scale: float, precision: str = "float32"):
    """Group mins f32[Q, N/128] of the factored distance block at the tier
    :func:`tier_of` picks.

    A CPU tensor runs :func:`fused_groupmin_reference`. A CUDA tensor
    launches the tier's kernel or raises; it never falls back."""
    tier = tier_of(q, precision)
    _check_contract(q, x, q_term, x_term, tier)
    if q.device.type == "cpu":
        return fused_groupmin_reference(q, x, q_term, x_term, scale, precision)
    if q.device.type != "cuda":
        raise ValueError(f"fused_groupmin: unsupported device {q.device}")
    for name, t in (("q", q), ("x", x), ("q_term", q_term), ("x_term", x_term)):
        want = q.dtype if name in ("q", "x") else torch.float32
        if t.device != q.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"fused_groupmin: {name} must be a contiguous {want} tensor on {q.device}; "
                f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name in ("q", "x") and t.data_ptr() % 16:  # the kernels load 16-byte vectors
            raise ValueError(f"fused_groupmin: {name} is not 16-byte aligned")
    qn, d = q.shape
    n = x.shape[0]
    out = torch.empty((qn, n // GROUP), dtype=torch.float32, device=q.device)
    if qn == 0 or n == 0:
        return out
    lname, entry, _ = _ENTRY[tier]
    lib = _load(lname)
    with torch.cuda.device(q.device):
        scratch = ()
        if lname in _SCRATCH_BYTES:
            fname, extra = _SCRATCH_BYTES[lname]
            nbytes = getattr(lib, fname)(qn, d, *((int(tier == "high"),) if extra else ()))
            if nbytes < 0:
                raise RuntimeError(f"groupmin {tier}: no kernel plan fits {q.device} at d={d}")
            # freed on return: the caching allocator hands the block only to
            # work queued after this launch on the same stream
            buf = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
            scratch = (buf.data_ptr(), nbytes)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), x.data_ptr(), q_term.data_ptr(), x_term.data_ptr(), out.data_ptr(),
            qn, n, d, float(scale), *scratch, stream,
        )
    if err != 0:
        msg = lib.tk_error_string(err).decode()
        raise RuntimeError(f"groupmin {tier} kernel launch failed: {msg} ({err})")
    launches[tier] += 1
    return out
