"""The string spaces (leven, normleven) and the dummy method in the port
(device="cpu"), held against tpu_knn on the same seeded inputs and against
a plain Python Levenshtein (tests/test_string_spaces.py's ``py_leven``).

Edit distances are exact integers in both packages, so leven must equal
tpu_knn exactly, and normleven (one f32 division) bit for bit; integer
distances tie in bulk, so the kNN and HNSW tests compare ids and graphs
array for array: both packages break ties alike on the CPU (the port
scans tpu_knn's 128-row chunks there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.ops import edit as JE  # noqa: E402
from tpu_knn_torch import DataKind, DistKind, Index, Params  # noqa: E402
from tpu_knn_torch.core.dataset import DataStore  # noqa: E402
from tpu_knn_torch.core.registry import create_space  # noqa: E402
from tpu_knn_torch.ops import edit as TE  # noqa: E402

CPU = {"device": "cpu"}
PKGS = ((tpu_knn, {}), (tpu_knn_torch, CPU))


def py_leven(a: bytes, b: bytes) -> int:
    la, lb = len(a), len(b)
    prev = list(range(la + 1))
    for i in range(1, lb + 1):
        cur = [i] + [0] * la
        for j in range(1, la + 1):
            cost = 0 if a[j - 1] == b[i - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[la]


def _random_bytes(n, seed, hi=40, alphabet=None):
    """n seeded byte strings of lengths 0..hi (two of them empty)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = 0 if i < 2 else int(rng.integers(0, hi + 1))
        vals = rng.integers(0, 256, ln) if alphabet is None else np.frombuffer(alphabet, np.uint8)[
            rng.integers(0, len(alphabet), ln)]
        out.append(bytes(np.asarray(vals, np.uint8)))
    return out


def _pack(strings):
    width = max(max((len(s) for s in strings), default=1), 1)
    chars = np.zeros((len(strings), width), np.int32)
    lens = np.zeros(len(strings), np.int32)
    for i, s in enumerate(strings):
        chars[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return chars, lens


def test_levenshtein_blocked_equals_tpu_knn_and_python():
    qs, xs = _random_bytes(12, 1), _random_bytes(30, 2)
    (qc, ql), (xc, xl) = _pack(qs), _pack(xs)
    got = TE.levenshtein_blocked(*(torch.from_numpy(a) for a in (qc, ql, xc, xl))).numpy()
    ref = np.asarray(JE.levenshtein_blocked(*(jnp.asarray(a) for a in (qc, ql, xc, xl))))
    np.testing.assert_array_equal(got, ref)
    want = np.array([[py_leven(q, x) for x in xs] for q in qs])
    np.testing.assert_array_equal(got, want)
    # the gathered and pair forms of the same DP
    gx = torch.from_numpy(np.broadcast_to(xc, (12,) + xc.shape).copy())
    gl = torch.from_numpy(np.broadcast_to(xl, (12, 30)).copy())
    np.testing.assert_array_equal(
        TE.levenshtein_gathered(torch.from_numpy(qc), torch.from_numpy(ql), gx, gl).numpy(), want)
    np.testing.assert_array_equal(TE.levenshtein_pairs(
        torch.from_numpy(qc)[None], torch.from_numpy(ql)[None], torch.from_numpy(xc)[None],
        torch.from_numpy(xl)[None])[0].numpy(), want)


def test_normleven_bit_equal_tpu_knn():
    qs, xs = _random_bytes(10, 3), _random_bytes(25, 4)
    (qc, ql), (xc, xl) = _pack(qs), _pack(xs)
    got = TE.normalized_levenshtein_blocked(*(torch.from_numpy(a) for a in (qc, ql, xc, xl))).numpy()
    ref = np.asarray(JE.normalized_levenshtein_blocked(*(jnp.asarray(a) for a in (qc, ql, xc, xl))))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert got[0, 0] == 0.0  # two empty strings


@pytest.mark.parametrize("cap", [1, 7, 50, 400])
def test_result_independent_of_the_chunk(monkeypatch, cap):
    """The DP's blocking over queries and corpus rows (block_elems) and the
    scan's chunk (chunkSize) change no distance."""
    qs, xs = _random_bytes(9, 5, hi=20), _random_bytes(70, 6, hi=20)
    (qc, ql), (xc, xl) = _pack(qs), _pack(xs)
    args = [torch.from_numpy(a) for a in (qc, ql, xc, xl)]
    whole = TE.levenshtein_blocked(*args)
    monkeypatch.setattr(TE, "block_elems", lambda dev: cap)
    np.testing.assert_array_equal(TE.levenshtein_blocked(*args).numpy(), whole.numpy())
    monkeypatch.undo()
    res = []
    for chunk in (8, 64):
        idx = Index("leven", method="seq_search", data_type=DataKind.STRING, dist_type=DistKind.INT, **CPU)
        idx.add_string_batch(xs)
        idx.build_index(Params(chunkSize=chunk))
        res.append(idx.knn_query_batch(qs, 70)[0])
    np.testing.assert_array_equal(res[0], res[1])
    np.testing.assert_array_equal(res[0], np.sort(whole.numpy(), axis=1).astype(np.float32))


def test_leven_space_block_and_pairwise():
    """tests/test_string_spaces.py's kernel case on the port's space, and
    get_distance."""
    words = [b"kitten", b"sitting", b"", b"a", b"abcdefghij", b"abcdefhgij", b"banana", b"bananas"]
    space = create_space("leven", **CPU)
    store = DataStore(DataKind.STRING)
    store.add_string_batch(words)
    data = space.encode_dataset(store)
    qs = [b"kitten", b"siting", b"xyz", b""]
    d = space.block(space.encode_queries(qs), space.slice_data(data, 0, data.ids.shape[0])).numpy()
    for i, q in enumerate(qs):
        for j, x in enumerate(words):
            assert int(d[i, j]) == py_leven(q, x), (q, x)
    idx = Index("leven", method="seq_search", data_type=DataKind.STRING, dist_type=DistKind.INT, **CPU)
    idx.add_string_batch([b"hello", b"hallo", b"help", b"world"])
    res = idx.knn_query("hello", 2)
    assert list(res.ids) == [0, 1] and list(res.dists) == [0, 1]
    assert idx.get_distance(0, 1) == 1 and isinstance(idx.get_distance(0, 1), int)


def _both(name, dt, method, xs, build=None, query_params=None):
    out = []
    for pkg, kw in PKGS:
        idx = pkg.Index(name, method=method, data_type="object_as_string", dist_type=dt, **kw)
        idx.add_string_batch(xs)
        if build is not None:
            idx.build_index(pkg.Params(build))
        if query_params is not None:
            idx.set_query_time_params(pkg.Params(query_params))
        out.append(idx)
    return out


@pytest.mark.parametrize("name,dt", [("leven", "int"), ("normleven", "float")])
def test_seq_search_equals_tpu_knn(name, dt):
    """Both scan routes: 300 strings at k=7 stay single-pass, 4200 at k=2
    (33 chunks of 128) go two-pass; ids and distances equal array for array."""
    xs = _random_bytes(4200, 7, hi=12, alphabet=b"ACGT")
    qs = _random_bytes(24, 8, hi=12, alphabet=b"ACGT")
    for n, k, route in ((300, 7, "single"), (4200, 2, "twopass")):
        a, b = _both(name, dt, "seq_search", xs[:n])
        (d1, i1), (d2, i2) = a.knn_query_batch(qs, k), b.knn_query_batch(qs, k)
        assert b.method.last_route == route
        np.testing.assert_array_equal(d2, d1)
        np.testing.assert_array_equal(i2, i1)
        r1, r2 = a.range_query_batch(qs[:6], 3 if dt == "int" else 0.3), b.range_query_batch(qs[:6], 3 if dt == "int" else 0.3)
        for x, y in zip(r1, r2):
            assert set(x.ids.tolist()) == set(y.ids.tolist())


@pytest.mark.parametrize("name,dt", [("leven", "int"), ("normleven", "float")])
def test_hnsw_equals_tpu_knn(tmp_path, name, dt):
    """HNSW over 160 strings (M=6, efConstruction=20): level 0, the upper
    levels and the results equal tpu_knn's array for array (integer
    distances score exactly alike in both), and files cross both ways."""
    xs = _random_bytes(160, 9, hi=10, alphabet=b"ACGT")
    a, b = _both(name, dt, "hnsw", xs, dict(M=6, efConstruction=20, waveSize=32), dict(efSearch=30))
    np.testing.assert_array_equal(b.method.graph["level0"].numpy(), np.asarray(a.method.graph["level0"]))
    assert len(a.method._upper) == len(b.method._upper)
    for ua, ub in zip(a.method._upper, b.method._upper):
        np.testing.assert_array_equal(ub.numpy(), np.asarray(ua))
    qs = xs[:16]
    (d1, i1), (d2, i2) = a.knn_query_batch(qs, 5), b.knn_query_batch(qs, 5)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(i2, i1)
    assert (d2[:, 0] == 0).all()
    for src, dst, kw in ((a, tpu_knn_torch, CPU), (b, tpu_knn, {})):
        p = str(tmp_path / f"s_{dst.__name__}")
        src.save(p)
        back = dst.Index.load(p, **kw)
        back.set_query_time_params(dst.Params(efSearch=30))
        np.testing.assert_array_equal(back.knn_query_batch(qs, 5)[1], i1)


@pytest.mark.parametrize("space", ["l2", "leven"])
def test_dummy_both_ways(space):
    """dummy: empty results without doSeqSearch, the exact scan's with it,
    as in tpu_knn (tests/test_methods.py test_dummy_method)."""
    rng = np.random.default_rng(10)
    if space == "l2":
        x = rng.standard_normal((40, 12)).astype(np.float32)
        mk = lambda pkg, kw: pkg.Index("l2", pkg.Params(dim=12), method="dummy", **kw)  # noqa: E731
        add, q = "add_dense_batch", x[:3]
    else:
        x = _random_bytes(40, 11, hi=8, alphabet=b"ab")
        mk = lambda pkg, kw: pkg.Index("leven", method="dummy", data_type="object_as_string",  # noqa: E731
                                       dist_type="int", **kw)
        add, q = "add_string_batch", x[:3]
    res = {}
    for pkg, kw in PKGS:
        idx = mk(pkg, kw)
        getattr(idx, add)(x)
        d, ids = idx.knn_query_batch(q, 2)
        assert (ids == -1).all() and np.isinf(d).all()
        assert all(len(r) == 0 for r in idx.range_query_batch(q, 1.0))
        idx2 = mk(pkg, kw)
        getattr(idx2, add)(x)
        idx2.build_index(pkg.Params(doSeqSearch=True))
        res[pkg.__name__] = idx2.knn_query_batch(q, 2)
    d1, i1 = res["tpu_knn"]
    d2, i2 = res["tpu_knn_torch"]
    np.testing.assert_array_equal(i2, i1)
    # the self-distance of l2 is the norm identity's cancellation (sqrt ~1e-3)
    np.testing.assert_allclose(d2[:, 1:], d1[:, 1:], rtol=5e-3, atol=1e-5)
    assert (d2[:, 0] <= 5e-3).all()  # each query is a stored point
    if space == "l2":
        assert (i2[:, 0] == np.arange(3)).all()


def test_prefix_min_forms_agree():
    """The card's prefix min (torch.cummin along axis 0) and the CPU's loop
    of torch.minimum give the same integers (the card's form run here on
    the CPU)."""
    e = torch.from_numpy(np.random.default_rng(12).integers(-50, 50, (41, 7, 13)).astype(np.int32))
    np.testing.assert_array_equal(TE._prefix_min(e.clone()).numpy(), torch.cummin(e, dim=0).values.numpy())
