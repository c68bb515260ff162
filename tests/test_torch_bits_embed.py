"""The bit spaces (bit_hamming, bit_jaccard, Index.add_bit_batch_packed)
and word_embed with the string store in the port (device="cpu"), held
against tpu_knn on the same seeded numpy inputs.

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties. Hamming distances are integers and must be equal exactly:
the 0/1 products are exact in f32 in both packages. word_embed delegates
to the dense l2/cosine spaces, so its results equal Index("l2") /
Index("cosinesimil") over the parsed vectors bit for bit in the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.spaces import bits as JB  # noqa: E402
from tpu_knn_torch.methods import seq_search as TSS  # noqa: E402
from tpu_knn_torch.ops import groupmin as TGM  # noqa: E402
from tpu_knn_torch.spaces import bits as TB  # noqa: E402
from tpu_knn_torch.spaces.embed import parse_embed_line  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
PKGS = (tpu_knn, tpu_knn_torch)
DIST = {"bit_hamming": "int", "bit_jaccard": "float"}


def _bits(n: int, nbits: int, seed: int, p: float = 0.4) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, nbits)) < p).astype(np.uint8)


def _bit_index(pkg, name, x, build=None):
    idx = pkg.Index(name, method="seq_search", data_type="dense_uint8_vector", dist_type=DIST[name],
                    **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_uint8_batch(x)
    if build is not None:
        idx.build_index(build)
    return idx


def _assert_same_knn(ref, got, exact: bool = False):
    """Distances within the tolerance (equal when ``exact``); an id the
    port returns where the reference returns another ties a reference
    distance of its row."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    if exact:
        np.testing.assert_array_equal(d2, d1)
    else:
        np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, -1], rtol=RTOL, atol=ATOL), (r, c)


# ---------------- bits ----------------


@pytest.mark.parametrize("n_bits", [None, 75, 96, 1])
def test_unpack_bit_vectors_bit_equal(n_bits):
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(9, 3), dtype=np.uint64).astype(np.uint32)
    if n_bits is not None and n_bits < 96:
        words[:, n_bits // 32] &= np.uint32((1 << (n_bits % 32)) - 1)
        words[:, n_bits // 32 + 1:] = 0
    got = TB.unpack_bit_vectors(words, n_bits)
    np.testing.assert_array_equal(got, JB.unpack_bit_vectors(words, n_bits))
    assert got.dtype == np.uint8 and got.shape == (9, 96 if n_bits is None else n_bits)


@pytest.mark.parametrize("words,n_bits", [
    (np.zeros((4, 2), np.uint16), None),  # not uint32
    (np.zeros((4, 2), np.int32), None),  # signed
    (np.zeros(8, np.uint32), None),  # 1-D
    (np.zeros((4, 2), np.uint32), 0),  # n_bits out of range
    (np.zeros((4, 2), np.uint32), 65),
    (np.full((4, 2), 2**31, np.uint32), 40),  # padding bit set
])
def test_packed_ingestion_errors_equal_tpu_knn(words, n_bits):
    """add_bit_batch_packed raises tpu_knn's exception class for each bad
    input, and adds nothing."""
    kinds = []
    for pkg in PKGS:
        idx = pkg.Index("bit_hamming", method="seq_search", data_type="dense_uint8_vector", dist_type="int",
                        **(CPU if pkg is tpu_knn_torch else {}))
        with pytest.raises(pkg.InvalidArgumentError) as e:
            idx.add_bit_batch_packed(words, n_bits=n_bits)
        kinds.append(type(e.value).__name__)
        assert idx.data_qty() == 0
    assert kinds[0] == kinds[1]


def test_packed_ingestion_matches_unpacked_and_tpu_knn():
    """u32-word-packed bits (bit j of word i = element 32i+j) give the
    results of the unpacked rows, in both packages."""
    bits = _bits(96, 75, 3, p=0.35)
    padded = np.zeros((96, 96), np.uint8)
    padded[:, :75] = bits
    words = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    out = []
    for pkg in PKGS:
        a = _bit_index(pkg, "bit_hamming", bits)
        b = pkg.Index("bit_hamming", method="seq_search", data_type="dense_uint8_vector", dist_type="int",
                      **(CPU if pkg is tpu_knn_torch else {}))
        b.add_bit_batch_packed(words, n_bits=75, ids=list(range(100, 196)))
        da, ia = a.knn_query_batch(bits[:8], 5)
        db, ib = b.knn_query_batch(bits[:8], 5)
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(ia + 100, ib)
        out.append((da, ia))
    _assert_same_knn(out[0], out[1], exact=True)


@pytest.mark.parametrize("name", ["bit_hamming", "bit_jaccard"])
def test_bit_knn_both_routes_match_tpu_knn(name):
    """3,000 rows of 100 bits (padded to 128 columns): the single-pass
    scan and the two-pass route (chunkSize=128) through the API, and the
    two-pass function at k=10; Hamming distances exactly equal to tpu_knn's
    and to the popcount of the XOR, Jaccard within the tolerance."""
    x = _bits(3000, 100, 11)
    q = _bits(16, 100, 12)
    q[0] = x[7]
    for build, k, route in ((None, 10, "single"), ({"chunkSize": 128}, 1, "twopass")):
        j, t = _bit_index(tpu_knn, name, x, build), _bit_index(tpu_knn_torch, name, x, build)
        ref, got = j.knn_query_batch(q, k), t.knn_query_batch(q, k)
        assert t.method.last_route == route
        _assert_same_knn(ref, got, exact=name == "bit_hamming")
    assert t.method.data.vecs.dtype == torch.float32  # never the int8 tier
    d, ids, _, _, _ = TSS._knn_device_twopass(t.space, t.space.encode_queries(q), t.method.data, 10, 128,
                                              "float32")
    ref = _bit_index(tpu_knn, name, x).knn_query_batch(q, 10)
    got = (d.numpy(), ids.numpy())
    if name == "bit_hamming":
        got = (np.rint(got[0]), got[1])
        pop = (q[:, None, :] != x[np.maximum(got[1], 0)]).sum(-1)
        np.testing.assert_array_equal(got[0], pop)
        assert got[1][0, 0] == 7 and got[0][0, 0] == 0
    _assert_same_knn(ref, got, exact=name == "bit_hamming")


def test_bit_spaces_forms():
    """bit_hamming is Int with the affine form (-2, 1, 1) and the post
    max(s, 0); bit_jaccard is Float with no affine form (block route)."""
    h = tpu_knn_torch.core.registry.create_space("bit_hamming", None, device="cpu")
    jac = tpu_knn_torch.core.registry.create_space("bit_jaccard", None, device="cpu")
    assert h.dist_kind is tpu_knn_torch.DistKind.INT and h.pass1_affine() == (-2.0, 1.0, 1.0)
    assert float(h.pass1_post(torch.tensor([-1e-6]), {})[0]) == 0.0
    assert jac.dist_kind is tpu_knn_torch.DistKind.FLOAT and jac.pass1_affine() is None
    with pytest.raises(tpu_knn_torch.InvalidArgumentError):
        h.encode_queries(np.full((1, 8), 2, np.uint8))


@pytest.mark.parametrize("name", ["bit_hamming", "bit_jaccard"])
def test_bit_distance_range_and_files_cross(tmp_path, name):
    """get_distance, range at the median 5th distance, and a saved index
    of either package loads and answers the same in the other."""
    x = _bits(500, 100, 21)
    q = _bits(6, 100, 22)
    j, t = _bit_index(tpu_knn, name, x), _bit_index(tpu_knn_torch, name, x)
    assert t.get_distance(3, 9) == pytest.approx(j.get_distance(3, 9), rel=RTOL, abs=ATOL)
    ref = j.knn_query_batch(q, 5)
    radius = float(np.median(ref[0][:, -1]))
    for rj, rt in zip(j.range_query_batch(q, radius), t.range_query_batch(q, radius)):
        assert set(rj.ids) == set(rt.ids)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / f"{name}_{reader.__name__}")
        src.save(path)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        _assert_same_knn(ref, back.knn_query_batch(q, 5), exact=name == "bit_hamming")


def test_bit_hamming_hnsw_matches_tpu_knn():
    """The default method over bit_hamming: the wave build gives tpu_knn's
    level-0 neighbour sets, and search returns exact Hamming distances."""
    x = _bits(600, 64, 31, p=0.5)
    build = {"M": 8, "efConstruction": 40, "waveSize": 64, "seed": 0}
    g = []
    for pkg in PKGS:
        idx = pkg.Index("bit_hamming", data_type="dense_uint8_vector", dist_type="int",
                        **(CPU if pkg is tpu_knn_torch else {}))
        idx.add_uint8_batch(x)
        idx.build_index(build)
        g.append((idx, np.asarray(idx.method.graph["level0"])))
    for a, b in zip(g[0][1], g[1][1]):
        assert set(a[a >= 0]) == set(b[b >= 0])
    d, i = g[1][0].knn_query_batch(x[:8], 5)
    np.testing.assert_array_equal(d, (x[:8, None, :] != x[i]).sum(-1))
    assert (i[:, 0] == np.arange(8)).all()


# ---------------- word_embed ----------------


def _lines(n: int, d: int, seed: int):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return [f"w{i} " + " ".join(f"{a:.9g}" for a in row) for i, row in enumerate(v)], v


def _embed_index(pkg, params, lines, method="seq_search", build=None):
    idx = pkg.Index("word_embed", pkg.Params(params), method=method, data_type="object_as_string",
                    **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_string_batch(lines)
    if build is not None:
        idx.build_index(build)
    return idx


def test_parse_embed_line():
    w, v = parse_embed_line(b"cat 1 2.5 -3e-2")
    assert w == "cat" and v.dtype == np.float32 and v.tolist() == [1.0, 2.5, np.float32(-3e-2)]
    for bad in ("cat", "cat 1 x"):
        with pytest.raises(tpu_knn_torch.InvalidArgumentError):
            parse_embed_line(bad)


@pytest.mark.parametrize("dist", ["l2", "cosine"])
def test_word_embed_file_preload_and_bare_words(tmp_path, dist):
    """The ``file`` preload lets queries be bare words; results equal
    tpu_knn's, and the port's equal Index over the parsed vectors bit for
    bit; the string store borrows its lines back."""
    lines, v = _lines(300, 12, 41)
    f = tmp_path / "emb.txt"
    f.write_text("\n".join(lines) + "\n")
    words = [ln.split()[0] for ln in lines]
    out = []
    for pkg in PKGS:
        # the corpus holds the first 250 words; queries are 10 others (a
        # self-query's l2 distance is sqrt of the norm identity's noise)
        idx = _embed_index(pkg, {"dist": dist, "file": str(f)}, words[:250])
        out.append(idx.knn_query_batch(words[250:260], 4))
        assert idx.borrow_data_point_string(5) == "w5"
        r = idx.knn_query("w3", 2)
        assert r.ids[0] == 3
    _assert_same_knn(out[0], out[1])
    inner = "l2" if dist == "l2" else "cosinesimil"
    ref = tpu_knn_torch.Index(inner, {"dim": 12}, method="seq_search", **CPU)
    ref.add_dense_batch(v[:250])
    d, i = ref.knn_query_batch(v[250:260], 4)
    np.testing.assert_array_equal(out[1][0], d)
    np.testing.assert_array_equal(out[1][1], i)


def test_word_embed_errors_equal_tpu_knn(tmp_path):
    """No dist, an unknown dist, an unknown word, a missing file and
    ragged dimensions raise tpu_knn's classes."""
    lines, _ = _lines(20, 6, 43)
    cases = [
        ({}, None, None),
        ({"dist": "cityblock"}, None, None),
        ({"dist": "l2", "file": str(tmp_path / "missing.txt")}, None, None),
        ({"dist": "l2"}, lines, ["w99"]),
        ({"dist": "l2"}, lines + ["odd 1 2"], None),
    ]
    for params, data, query in cases:
        names = []
        for pkg in PKGS:
            with pytest.raises(pkg.NmsError) as e:
                idx = pkg.Index("word_embed", pkg.Params(params), method="seq_search",
                                data_type="object_as_string", **(CPU if pkg is tpu_knn_torch else {}))
                idx.add_string_batch(data)
                idx.knn_query_batch(query or lines[:2], 2)
            names.append(type(e.value).__name__)
        assert names[0] == names[1], (params, names)


@pytest.mark.parametrize("dist", ["l2", "cosine"])
def test_word_embed_hnsw_matches_tpu_knn(dist):
    """HNSW over word_embed reaches the inner space's scoring hooks: the
    wave build gives tpu_knn's level-0 neighbour sets on clustered lines,
    and the port's graph and results equal those of Index over the parsed
    vectors."""
    from tpu_knn_torch.eval.datasets import clustered

    pts = clustered(308, 12, n_clusters=10, seed=3)  # 300 corpus rows, 8 queries
    lines = [f"w{i} " + " ".join(f"{a:.9g}" for a in row) for i, row in enumerate(pts)]
    build = {"M": 8, "efConstruction": 40, "waveSize": 32, "seed": 0}
    idx = [_embed_index(pkg, {"dist": dist}, lines[:300], method="hnsw", build=build) for pkg in PKGS]
    for a, b in zip(np.asarray(idx[0].method.graph["level0"]), idx[1].method.graph["level0"].numpy()):
        assert set(a[a >= 0]) == set(b[b >= 0])
    for ix in idx:
        ix.set_query_time_params({"efSearch": 60})
    ref, got = idx[0].knn_query_batch(lines[300:], 3), idx[1].knn_query_batch(lines[300:], 3)
    _assert_same_knn(ref, got)
    plain = tpu_knn_torch.Index("l2" if dist == "l2" else "cosinesimil", {"dim": 12}, **CPU)
    plain.add_dense_batch(pts[:300])
    plain.build_index(build)
    assert torch.equal(plain.method.graph["level0"], idx[1].method.graph["level0"])
    plain.set_query_time_params({"efSearch": 60})
    d, i = plain.knn_query_batch(pts[300:], 3)
    np.testing.assert_array_equal(got[0], d)
    np.testing.assert_array_equal(got[1], i)


@pytest.mark.parametrize("method", ["seq_search", "hnsw"])
def test_word_embed_files_cross(tmp_path, method):
    """A word_embed index (its string store) saved by either package loads
    in the other, in both save modes, and answers the same."""
    lines, _ = _lines(200, 8, 45)
    build = {"M": 8, "efConstruction": 40, "waveSize": 32, "seed": 0} if method == "hnsw" else None
    j = _embed_index(tpu_knn, {"dist": "cosine"}, lines, method, build)
    t = _embed_index(tpu_knn_torch, {"dist": "cosine"}, lines, method, build)
    ref = t.knn_query_batch(lines[:6], 4)
    _assert_same_knn(j.knn_query_batch(lines[:6], 4), ref)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn), (t, tpu_knn_torch)):
        for save_data in (True, False):
            path = str(tmp_path / f"{reader.__name__}_{save_data}")
            src.save(path, save_data=save_data)
            back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
            assert back.borrow_data_point_string(7) == lines[7]
            got = back.knn_query_batch(lines[:6], 4)
            if src is t and reader is tpu_knn_torch:
                np.testing.assert_array_equal(got[0], ref[0])
                np.testing.assert_array_equal(got[1], ref[1])
            else:
                _assert_same_knn(ref, got)


def test_glove_like_bit_identical(tmp_path, monkeypatch):
    from tpu_knn.eval import datasets as jds
    from tpu_knn_torch.eval import datasets as tds

    monkeypatch.setattr(jds, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tds, "_CACHE_DIR", str(tmp_path / "torch"))
    a, b = jds.glove_like(700, 20, seed=4), tds.glove_like(700, 20, seed=4)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.glove_like(700, 20, seed=4), b)


def test_no_groupmin_launch_counted_on_the_cpu():
    """On the CPU the two-pass bit_hamming scan runs the kernel's plain
    version, which counts no launch."""
    TGM.reset_launches()
    _bit_index(tpu_knn_torch, "bit_hamming", _bits(3000, 100, 51), {"chunkSize": 128}).knn_query_batch(
        _bits(4, 100, 52), 1)
    assert set(TGM.launches.values()) == {0}
