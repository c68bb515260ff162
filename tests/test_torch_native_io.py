"""The port's native host runtime (tpu_knn_torch/io/native.py: ctypes over
native/libtpu_knn_native.so, numpy fallbacks): every function of
tests/test_native_io.py, once through the library and once through the
fallback, each held to tpu_knn's io.native on the same inputs."""

import shutil

import numpy as np
import pytest

from tpu_knn.io import native as J
from tpu_knn_torch.io import native as N


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """The port's module with its library loaded, or with the library
    hidden so that every routine takes its numpy fallback."""
    if request.param == "native":
        if not N.available():
            pytest.skip("the native library does not build here")
    else:
        monkeypatch.setattr(N, "load", lambda: None)
    return request.param


def test_read_dense_text(tmp_path, backend):
    mat = np.random.default_rng(1).standard_normal((23, 7)).astype(np.float32)
    p = tmp_path / "dense.txt"
    np.savetxt(p, mat, fmt="%.6f")
    got = N.read_dense_text(str(p))
    np.testing.assert_allclose(got, mat, atol=1e-5)
    np.testing.assert_array_equal(got, J.read_dense_text(str(p)))


def test_read_dense_text_blank_lines(tmp_path, backend):
    p = tmp_path / "d.txt"
    p.write_text("1 2 3\n\n4 5 6\n   \n7 8 9\n")
    got = N.read_dense_text(str(p))
    assert got.shape == (3, 3) and got[2, 2] == 9.0
    np.testing.assert_array_equal(got, J.read_dense_text(str(p)))


def test_read_sparse_text(tmp_path, backend):
    p = tmp_path / "s.txt"
    p.write_text("1:0.5 7:1.5\n2:2.0\n3:1.0 4:2.0 9:3.0\n")
    row_len, ids, vals = N.read_sparse_text(str(p))
    assert row_len.tolist() == [2, 1, 3]
    assert ids.tolist() == [1, 7, 2, 3, 4, 9]
    np.testing.assert_allclose(vals, [0.5, 1.5, 2.0, 1.0, 2.0, 3.0])
    for a, b in zip((row_len, ids, vals), J.read_sparse_text(str(p))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_read_sparse_text_id_order_rejected(tmp_path, backend):
    p = tmp_path / "bad.txt"
    p.write_text("3:1.0 2:1.0\n")
    with pytest.raises(IOError):
        N.read_sparse_text(str(p))


def test_pack_csr_roundtrip(backend):
    row_len = np.asarray([2, 0, 3], np.int32)
    ids = np.asarray([1, 5, 2, 3, 9], np.int32)
    vals = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    col, val, length = N.pack_csr(row_len, ids, vals, n_pad=4, nnz_pad=8, pad_col=2**31 - 2)
    assert col.shape == (4, 8)
    assert col[0, :2].tolist() == [1, 5] and val[0, 1] == 2.0
    assert length.tolist() == [2, 0, 3, 0]
    assert (col[1] == 2**31 - 2).all()


@pytest.mark.parametrize("pad_col", [2**31 - 1, 2**31 - 2])
def test_pack_csr_equals_tpu_knn(backend, pad_col):
    """Ragged rows (some empty, some cut at nnz_pad) packed like tpu_knn
    packs them, array for array."""
    rng = np.random.default_rng(7)
    row_len = rng.integers(0, 20, size=37).astype(np.int32)
    ids = np.concatenate([np.sort(rng.choice(np.arange(1, 500), n, replace=False)) for n in row_len])
    vals = rng.standard_normal(ids.shape[0]).astype(np.float32)
    got = N.pack_csr(row_len, ids.astype(np.int32), vals, 40, 16, pad_col)
    want = J.pack_csr(row_len, ids.astype(np.int32), vals, 40, 16, pad_col)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_strings(backend):
    chars, length = N.pack_strings([b"ab", b"", b"xyz"], n_pad=4, l_max=8)
    assert chars.shape == (4, 8)
    assert chars[0, 0] == ord("a") and chars[2, 2] == ord("z")
    assert length.tolist() == [2, 0, 3, 0]
    for a, b in zip((chars, length), J.pack_strings([b"ab", b"", b"xyz"], n_pad=4, l_max=8)):
        np.testing.assert_array_equal(a, b)


def test_native_levenshtein(backend):
    assert N.levenshtein(b"kitten", b"sitting") == 3
    assert N.levenshtein(b"", b"abc") == 3
    assert N.levenshtein(b"same", b"same") == 0
    assert N.levenshtein(b"flaw", b"lawn") == J.levenshtein(b"flaw", b"lawn") == 2


def test_vecs_roundtrip(tmp_path, backend):
    """fvecs/bvecs/ivecs (ANN benchmark binary format) written by the port
    read back by it and by tpu_knn."""
    x = (np.random.default_rng(0).random((50, 9)) * 10).astype(np.float32)
    for kind, arr in (("fvecs", x), ("bvecs", (x * 20).astype(np.uint8)), ("ivecs", (x * 100).astype(np.int32))):
        p = str(tmp_path / f"t.{kind}")
        N.write_vecs(p, arr)
        got = N.read_vecs(p)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(J.read_vecs(p), arr)


def test_vecs_malformed(tmp_path, backend):
    p = str(tmp_path / "bad.fvecs")
    with open(p, "wb") as f:
        f.write(np.int32(3).tobytes() + b"\x00" * 7)  # truncated record
    with pytest.raises(IOError):
        N.read_vecs(p)


def test_build_at_first_use(tmp_path, monkeypatch):
    """A checkout without the library builds it at the first call that
    wants it (make into a temporary file, then a rename), loads it, and
    does not try again after a failed build."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make or g++ here")
    src = tmp_path / "native"
    src.mkdir()
    for f in ("Makefile", "tpu_knn_native.cpp"):
        shutil.copy(f"{N._DIR}/{f}", src / f)
    lib_path = str(src / "libtpu_knn_native.so")
    monkeypatch.setattr(N, "_DIR", str(src))
    monkeypatch.setattr(N, "_LIB_PATH", lib_path)
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_build_ok", None)
    assert N.load() is not None and N._build_ok is True
    assert (src / "libtpu_knn_native.so").exists()
    assert not [p for p in src.iterdir() if p.name.endswith(".tmp")]
    assert N.levenshtein(b"kitten", b"sitting") == 3

    # a failed build is remembered: no second make in the same process
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "Makefile").write_text("all:\n\tfalse\n")
    monkeypatch.setattr(N, "_DIR", str(broken))
    monkeypatch.setattr(N, "_LIB_PATH", str(broken / "libtpu_knn_native.so"))
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_build_ok", None)
    assert N.load() is None and N._build_ok is False
    (broken / "Makefile").write_text("not a makefile at all")
    assert N.load() is None
