"""Pass 1 of the exact two-pass kNN scan: fused distance + 128-row group min.

Counterpart of ``tpu_knn/ops/pallas_scan.py`` (``fused_groupmin``). On a
CUDA tensor the wrapper launches the hand-written kernel in
``csrc/groupmin.cu`` (FP32 FFMA, no tensor cores); on a CPU tensor it runs
the plain PyTorch version, :func:`fused_groupmin_reference`, which is also
what the kernel is held against on the card.

The kernel is compiled with ``nvcc`` into a shared library with a plain C
interface on first use, keyed by a hash of its source and flags, under
``tpu_knn_torch/_build/``, and loaded with ``ctypes``. Nothing is built or
loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

GROUP = 128

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "groupmin.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: kernel launches made by :func:`fused_groupmin` (CUDA tensors only)
launches = 0

_lib = None
#: nvcc's output of the build that produced the loaded library ("" if cached)
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile ``csrc/groupmin.cu`` for sm_90a unless a library built from
    the same source and flags exists; return its path. Raises with nvcc's
    output when the build fails."""
    global build_log
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"groupmin-{key}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".groupmin-{key}.{os.getpid()}.so"
    r = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {r.returncode}) on {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    build_log = r.stdout + r.stderr
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        lib.tk_groupmin_f32.argtypes = [
            p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, p,
        ]
        lib.tk_groupmin_f32.restype = ctypes.c_int
        lib.tk_error_string.argtypes = [ctypes.c_int]
        lib.tk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_contract(q, x, q_term, x_term, precision: str) -> None:
    if precision != "float32":
        raise NotImplementedError(
            f"fused_groupmin precision {precision!r}: only the float32 tier is "
            "ported (ROADMAP.md, TPU kernels to port)"
        )
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"fused_groupmin needs q [Q, D] and x [N, D]; got {tuple(q.shape)}, {tuple(x.shape)}"
        )
    qn, d = q.shape
    n = x.shape[0]
    if n % GROUP or d % 8:
        raise ValueError(f"fused_groupmin needs n%{GROUP}==0 and d%8==0; got n={n} d={d}")
    if q_term.shape != (qn,) or x_term.shape != (n,):
        raise ValueError(
            f"fused_groupmin needs q_term [{qn}] and x_term [{n}]; "
            f"got {tuple(q_term.shape)}, {tuple(x_term.shape)}"
        )


def fused_groupmin_reference(q, x, q_term, x_term, scale: float, chunk_bytes: int = 1 << 28):
    """Plain PyTorch group mins [Q, N/128] of ``scale*<q,x> + x_term + q_term``
    in the inputs' dtype: one matmul per corpus chunk, then a reshape-min.
    Chunks keep the [Q, chunk] block under ``chunk_bytes``."""
    qn, n = q.shape[0], x.shape[0]
    per_row = max(qn, 1) * q.element_size()
    step = max(GROUP, (chunk_bytes // per_row) // GROUP * GROUP)
    outs = []
    for s in range(0, n, step):
        e = min(s + step, n)
        dd = scale * (q @ x[s:e].T) + x_term[None, s:e] + q_term[:, None]
        outs.append(dd.view(qn, (e - s) // GROUP, GROUP).amin(dim=2))
    if not outs:
        return q.new_empty((qn, 0))
    return torch.cat(outs, dim=1)


def fused_groupmin(q, x, q_term, x_term, scale: float, precision: str = "float32"):
    """Group mins f32[Q, N/128] of the factored distance block.

    A CPU tensor runs :func:`fused_groupmin_reference`. A CUDA tensor
    launches the kernel or raises; it never falls back."""
    _check_contract(q, x, q_term, x_term, precision)
    if q.device.type == "cpu":
        return fused_groupmin_reference(q, x, q_term, x_term, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_groupmin: unsupported device {q.device}")
    for name, t in (("q", q), ("x", x), ("q_term", q_term), ("x_term", x_term)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_groupmin: {name} must be a contiguous float32 tensor on {q.device}; "
                f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
        if name in ("q", "x") and t.data_ptr() % 16:  # the kernel loads float4s
            raise ValueError(f"fused_groupmin: {name} is not 16-byte aligned")
    qn, d = q.shape
    n = x.shape[0]
    out = torch.empty((qn, n // GROUP), dtype=torch.float32, device=q.device)
    if qn == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tk_groupmin_f32(
            q.data_ptr(), x.data_ptr(), q_term.data_ptr(), x_term.data_ptr(), out.data_ptr(),
            qn, n, d, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"groupmin kernel launch failed: {lib.tk_error_string(err).decode()} ({err})")
    global launches
    launches += 1
    return out
