"""ctypes bridge to the native host runtime (counterpart of
tpu_knn/io/native.py; native/tpu_knn_native.cpp, plain C ABI).

The reference's IO and packing layer is C++ (read_data.h,
space_vector.cc, thread_pool.h); this module exposes the same native
routines, threaded text parsing and padded-layout packing, over the
shared library both packages use, native/libtpu_knn_native.so, built
from native/tpu_knn_native.cpp by native/Makefile. Each routine keeps a
numpy fallback for when the library cannot be built or loaded, with the
same results.

The library is built at first use, never at import: the first call that
wants it runs ``make`` into a temporary file under a file lock and moves
the result into place, so concurrent processes neither race nor load a
half-written file. A failed build is not retried in the same process.
Host code only: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_DIR, "libtpu_knn_native.so")

#: native/Makefile's flags less -flto: the library is one translation unit,
#: so link-time optimization adds nothing, and a toolchain without the LTO
#: plugin fails the link
_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"

_lib = None
#: the outcome of this process's build attempt: None before any
_build_ok: bool | None = None


def build(quiet: bool = True) -> bool:
    """Compile the native library (``make -C native`` with ``_CXXFLAGS``)
    unless it is there, and load it. Returns True when it is loaded."""
    global _build_ok
    if not os.path.exists(_LIB_PATH):
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(_LIB_PATH):  # another process may have built it meanwhile
                    subprocess.run(["make", "-C", _DIR, "-B", f"LIB={tmp}", f"CXXFLAGS={_CXXFLAGS}"],
                                   check=True, capture_output=quiet, timeout=600)
                    os.replace(tmp, _LIB_PATH)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
            _build_ok = False
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _build_ok = _open() is not None
    return _build_ok


def load():
    """The ctypes library handle, built at the first call if need be, or
    None when it cannot be built or loaded."""
    if _lib is None and _build_ok is None:
        build()
    return _lib


def _open():
    """Load (once) and return the ctypes library handle, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    c = ctypes
    lib.tk_version.restype = c.c_int
    lib.tk_dense_text_shape.argtypes = [c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.tk_dense_text_read.argtypes = [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int]
    lib.tk_sparse_text_shape.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int64)
    ]
    lib.tk_sparse_text_read.argtypes = [
        c.c_char_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float), c.c_int64
    ]
    lib.tk_pack_csr.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_float),
        c.c_int64, c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_float), c.POINTER(c.c_int32), c.c_int,
    ]
    lib.tk_pack_strings.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.c_int64, c.c_int64, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
    ]
    lib.tk_levenshtein.argtypes = [c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_uint8), c.c_int64]
    lib.tk_levenshtein.restype = c.c_int
    try:
        lib.tk_vecs_shape.argtypes = [
            c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64)
        ]
        lib.tk_vecs_read.argtypes = [
            c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, c.c_int64, c.c_int
        ]
    except AttributeError:  # stale .so without the vecs readers
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


# ---------------- dense text ----------------


def read_dense_text(path: str, nthreads: int = 0) -> np.ndarray:
    """Read whitespace-separated float vectors, one per line
    (ReadVecDataEfficiently analog)."""
    lib = load()
    if lib is None:
        return np.loadtxt(path, dtype=np.float32, ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.tk_dense_text_shape(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"tk_dense_text_shape({path}) failed: {rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.tk_dense_text_read(path.encode(), _ptr(out, ctypes.c_float), rows.value, cols.value, nthreads)
    if rc != 0:
        raise IOError(f"tk_dense_text_read({path}) failed: {rc}")
    return out


# ---------------- fvecs / bvecs / ivecs (ANN benchmark binary) ----------------

_VECS_DTYPES = {"fvecs": np.float32, "bvecs": np.uint8, "ivecs": np.int32}


def read_vecs(path: str, kind: str | None = None, nthreads: int = 0) -> np.ndarray:
    """Read an fvecs/bvecs/ivecs file ([dim:i32][dim*elem] records — the
    SIFT-1M / GIST benchmark format) into an [n, dim] array. ``kind``
    defaults to the file extension."""
    kind = kind or os.path.splitext(path)[1].lstrip(".").lower()
    if kind not in _VECS_DTYPES:
        raise ValueError(f"unknown vecs kind {kind!r} (expected fvecs/bvecs/ivecs)")
    dtype = _VECS_DTYPES[kind]
    esz = np.dtype(dtype).itemsize
    lib = load()
    if lib is None or not hasattr(lib, "tk_vecs_shape"):
        raw = np.fromfile(path, dtype=np.uint8)
        if raw.size == 0:
            return np.zeros((0, 0), dtype)
        d = int(raw[:4].view(np.int32)[0])
        rec = 4 + d * esz
        if d <= 0 or raw.size % rec != 0:
            raise IOError(f"malformed {kind} file {path}")
        mat = raw.reshape(-1, rec)
        if not np.all(mat[:, :4].copy().view(np.int32)[:, 0] == d):
            raise IOError(f"inconsistent dims in {path}")
        return mat[:, 4:].copy().view(dtype).reshape(-1, d)
    rows = ctypes.c_int64()
    dim = ctypes.c_int64()
    rc = lib.tk_vecs_shape(path.encode(), esz, ctypes.byref(rows), ctypes.byref(dim))
    if rc != 0:
        raise IOError(f"tk_vecs_shape({path}) failed: {rc}")
    out = np.empty((rows.value, dim.value), dtype)
    rc = lib.tk_vecs_read(
        path.encode(), esz, out.ctypes.data_as(ctypes.c_void_p),
        rows.value, dim.value, nthreads,
    )
    if rc != 0:
        raise IOError(f"tk_vecs_read({path}) failed: {rc}")
    return out


def write_vecs(path: str, mat: np.ndarray, kind: str | None = None) -> None:
    """Write [n, dim] data in fvecs/bvecs/ivecs record format."""
    kind = kind or os.path.splitext(path)[1].lstrip(".").lower()
    dtype = _VECS_DTYPES[kind]
    mat = np.ascontiguousarray(mat, dtype)
    n, d = mat.shape
    rec = np.empty((n, 4 + d * mat.itemsize), np.uint8)
    rec[:, :4] = np.full((n, 1), d, np.int32).view(np.uint8)
    rec[:, 4:] = mat.view(np.uint8).reshape(n, -1)
    rec.tofile(path)


# ---------------- sparse text ----------------


def read_sparse_text(path: str):
    """Read 'id:val id:val ...' lines (1-based strictly-increasing ids).
    Returns (row_len i32[R], ids i32[nnz], vals f32[nnz])."""
    lib = load()
    if lib is None:
        return _read_sparse_text_py(path)
    r = ctypes.c_int64(); tot = ctypes.c_int64(); mx = ctypes.c_int64()
    rc = lib.tk_sparse_text_shape(path.encode(), ctypes.byref(r), ctypes.byref(tot), ctypes.byref(mx))
    if rc != 0:
        raise IOError(f"tk_sparse_text_shape({path}) failed: {rc}")
    row_len = np.zeros(r.value, np.int32)
    ids = np.empty(tot.value, np.int32)
    vals = np.empty(tot.value, np.float32)
    rc = lib.tk_sparse_text_read(
        path.encode(), _ptr(row_len, ctypes.c_int32), _ptr(ids, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), r.value,
    )
    if rc != 0:
        raise IOError(f"tk_sparse_text_read({path}) failed: {rc} (bad line or id order)")
    return row_len, ids, vals


def _read_sparse_text_py(path: str):
    row_len, ids, vals = [], [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            prev = 0
            n = 0
            for t in toks:
                i, v = t.split(":")
                i = int(i)
                if i < 1 or i <= prev:
                    raise IOError(f"sparse id order violation in {path}")
                prev = i
                ids.append(i)
                vals.append(float(v))
                n += 1
            row_len.append(n)
    return (
        np.asarray(row_len, np.int32),
        np.asarray(ids, np.int32),
        np.asarray(vals, np.float32),
    )


# ---------------- packers ----------------


def pack_csr(
    row_len: np.ndarray,
    ids: np.ndarray,
    vals: np.ndarray,
    n_pad: int,
    nnz_pad: int,
    pad_col: int,
    nthreads: int = 0,
):
    """Ragged CSR -> padded [n_pad, nnz_pad] (col, val, len)."""
    lib = load()
    rows = int(row_len.shape[0])
    if lib is None:
        out_col = np.full((n_pad, nnz_pad), pad_col, np.int32)
        out_val = np.zeros((n_pad, nnz_pad), np.float32)
        out_len = np.zeros(n_pad, np.int32)
        off = 0
        for i, n in enumerate(row_len):
            n = min(int(n), nnz_pad)
            out_col[i, :n] = ids[off : off + n]
            out_val[i, :n] = vals[off : off + n]
            out_len[i] = n
            off += int(row_len[i])
        return out_col, out_val, out_len
    row_len = np.ascontiguousarray(row_len, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    out_col = np.empty((n_pad, nnz_pad), np.int32)
    out_val = np.empty((n_pad, nnz_pad), np.float32)
    out_len = np.empty(n_pad, np.int32)
    lib.tk_pack_csr(
        _ptr(row_len, ctypes.c_int32), _ptr(ids, ctypes.c_int32), _ptr(vals, ctypes.c_float),
        rows, n_pad, nnz_pad, pad_col,
        _ptr(out_col, ctypes.c_int32), _ptr(out_val, ctypes.c_float), _ptr(out_len, ctypes.c_int32),
        nthreads,
    )
    return out_col, out_val, out_len


def pack_strings(strings: list[bytes], n_pad: int, l_max: int, nthreads: int = 0):
    """Ragged byte strings -> ([n_pad, l_max] i32 chars, i32 lengths)."""
    lib = load()
    rows = len(strings)
    if lib is None:
        chars = np.zeros((n_pad, l_max), np.int32)
        length = np.zeros(n_pad, np.int32)
        for i, s in enumerate(strings):
            b = np.frombuffer(s[:l_max], dtype=np.uint8)
            chars[i, : len(b)] = b
            length[i] = len(b)
        return chars, length
    blob = b"".join(strings)
    data = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(0, np.uint8)
    offsets = np.zeros(rows + 1, np.int64)
    np.cumsum([len(s) for s in strings], out=offsets[1:]) if rows else None
    chars = np.empty((n_pad, l_max), np.int32)
    length = np.empty(n_pad, np.int32)
    lib.tk_pack_strings(
        _ptr(np.ascontiguousarray(data), ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        rows, n_pad, l_max,
        _ptr(chars, ctypes.c_int32), _ptr(length, ctypes.c_int32), nthreads,
    )
    return chars, length


def levenshtein(a: bytes, b: bytes) -> int:
    lib = load()
    if lib is None:
        # tiny pure-python fallback
        la, lb = len(a), len(b)
        prev = list(range(la + 1))
        for i in range(1, lb + 1):
            cur = [i] + [0] * la
            for j in range(1, la + 1):
                cost = 0 if a[j - 1] == b[i - 1] else 1
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            prev = cur
        return prev[la]
    aa = np.frombuffer(a, dtype=np.uint8) if a else np.zeros(0, np.uint8)
    bb = np.frombuffer(b, dtype=np.uint8) if b else np.zeros(0, np.uint8)
    return int(
        lib.tk_levenshtein(
            _ptr(np.ascontiguousarray(aa), ctypes.c_uint8), len(a),
            _ptr(np.ascontiguousarray(bb), ctypes.c_uint8), len(b),
        )
    )
