"""The JL-sketch proxy of the sparse spaces in the port (device="cpu")
against tpu_knn: the projection R drawn without jax (threefry-2x32 in
jax's partitionable mode, jax's uniform map, XLA's f32 erf_inv) bit-equal
to jax.random.normal, the sketches of the corpus, the proxy HNSW build with
tpu_knn's R injected (every level's neighbour sets equal), sketchQuery=1
search, and sketch-proxy files crossing the packages, where the loader
draws R again from the stored seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.ops import sparse as JS  # noqa: E402
from test_torch_sparse import CPU, assert_same_graph, assert_same_knn, corpus, encode_both, index  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.ops import sparse as TS  # noqa: E402
from tpu_knn_torch.utils import rng as R  # noqa: E402

#: small proxy builds for the CPU (sketchDim 256)
PROXY_BUILD = dict(M=8, efConstruction=40, waveSize=128, seed=0, sketchDim=256)


def _key(seed):
    return jax.random.PRNGKey(jnp.uint32(seed))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
def test_random_bits_equal_jax(seed):
    """threefry-2x32 over the counter (0, i) under the key (0, seed) xored
    to one word: jax.random.bits in partitionable mode."""
    assert jax.config.jax_threefry_partitionable
    want = np.asarray(jax.random.bits(_key(seed), (5000,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(R.random_bits32(seed, 5000).numpy(), want)


def test_uniform_and_erfinv_equal_jax():
    """jax's uniform map onto [nextafter(-1, 0), 1), and XLA's f32 erf_inv
    on those values and on the edges of its two branches."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    bits = R.random_bits32(7, 20000)
    u = R._uniform_pm1(bits).numpy()
    np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(_key(7), (20000,), jnp.float32, lo, 1.0)))
    edges = np.asarray([-1.0, 1.0, lo, -0.999999, -0.99, -0.5, -1e-7, 0.0, 1e-7, 0.25, 0.9, 0.9933, 0.9934, 0.99999,
                        np.nextafter(np.float32(1), np.float32(0))], np.float32)
    x = np.concatenate([u, edges])
    np.testing.assert_array_equal(R.erfinv_xla(torch.from_numpy(x)).numpy(), np.asarray(jax.lax.erf_inv(x)))


@pytest.mark.parametrize("v_pad,dsk,seed", [(2048, 256, 0), (384, 1024, 3), (30080, 128, 2**32 - 1)])
def test_sketch_matrix_equals_jax(v_pad, dsk, seed):
    """R = jax.random.normal(PRNGKey(uint32(seed)), (v_pad, dsk)) / sqrt(dsk),
    bit for bit."""
    want = np.asarray(JS.sketch_matrix(v_pad, dsk, seed))
    got = TS.sketch_matrix(v_pad, dsk, seed).numpy()
    assert got.dtype == np.float32 and got.shape == (v_pad, dsk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["cosinesimil_sparse", "negdotprod_sparse", "sparse_jaccard", "angulardist_sparse"])
def test_sketch_proxy_matches_tpu_knn(name):
    """The proxy's dense rows (each space's normalized values through R),
    its query sketches and its scores, with the port drawing R itself and
    with tpu_knn's R given; the Lp spaces build no proxy; a wrong R shape
    raises."""
    xs, qs = corpus(300, 21), corpus(6, 22)
    js, ts, jd, td = encode_both(name, xs)
    jp, jpd, jr = js.sketch_proxy(jd, 200, 0)
    for r_mat in (None, np.asarray(jr)):
        tp, tpd, tr = ts.sketch_proxy(td, 200, 0, r_mat=r_mat)
        assert tp.dim == jp.dim == 256
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tpd.vecs.numpy(), np.asarray(jpd.vecs), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tpd.extra["pad"].numpy(), np.asarray(jpd.extra["pad"]))
        tq = ts.sketch_queries(ts.encode_queries(qs), tr)
        jq = js.sketch_queries(js.encode_queries(qs), jr)
        np.testing.assert_allclose(tq["q"].numpy(), np.asarray(jq["q"]), rtol=1e-5, atol=1e-6)
        got = tp.block(tq, {"x": tpd.vecs, "pad": tpd.extra["pad"]}).numpy()
        ref = np.asarray(jp.block(jq, {"x": jpd.vecs, "pad": jpd.extra["pad"]}))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(InvalidArgumentError):
        ts.sketch_proxy(td, 200, 0, r_mat=np.zeros((8, 256), np.float32))
    _, ls, _, ld = encode_both("l2_sparse", xs)
    assert ls.sketch_proxy(ld, 200, 0) is None


@pytest.mark.parametrize("name,n,extra", [
    ("cosinesimil_sparse", 1024, {}),
    ("sparse_jaccard", 512, {}),
    ("cosinesimil_sparse", 512, {"exactPost": 1, "exactShrink": 1}),
    ("negdotprod_sparse", 512, {"exactBase": 0, "exactPairs": 0}),
])
def test_proxy_build_with_tpu_knns_r_equals_tpu_knn(monkeypatch, name, n, extra):
    """The default HNSW build of a sparse dot-family or jaccard corpus runs
    on the sketch proxy; with tpu_knn's R given to the port (the test hook
    Hnsw.sketch_r), every level's rows hold tpu_knn's neighbour sets: the
    hybrid build (exactBase, exactPairs), the exact post pass and shrinks,
    and the proxy alone."""
    xs, qs = corpus(n, 23), corpus(16, 24)
    build = dict(PROXY_BUILD, **extra)
    j = index(tpu_knn, name, xs, "hnsw", build)
    v_pad = j.method.data.extra["vocab_mark"].shape[0]
    monkeypatch.setattr(TH.Hnsw, "sketch_r", np.asarray(JS.sketch_matrix(v_pad, 256, 0)))
    t = index(tpu_knn_torch, name, xs, "hnsw", build)
    assert t.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    assert t.method._proxy is None and t.method._exact_qenc_all is None  # dropped after the build
    assert_same_graph(t, j, n)
    for idx, pkg in ((j, tpu_knn), (t, tpu_knn_torch)):
        idx.set_query_time_params(pkg.Params(efSearch=40))
    assert_same_knn(name, xs, qs, j.knn_query_batch(qs, 10), t.knn_query_batch(qs, 10))


def test_sketch_query_search_and_files_cross(tmp_path):
    """sketchQuery=1 keeps the proxy for queries: a sketch-traversed beam
    re-ranked exactly. The port, drawing R itself, builds tpu_knn's graph
    and answers as tpu_knn does; a sketchQuery index saved by either
    package loads in the other, which draws R again from the seed, and
    answers the same; the proxy and R count in memory_usage_bytes."""
    xs, qs = corpus(700, 25), corpus(20, 26)
    build = dict(PROXY_BUILD, sketchQuery=1)
    j = index(tpu_knn, "cosinesimil_sparse", xs, "hnsw", build)
    t = index(tpu_knn_torch, "cosinesimil_sparse", xs, "hnsw", build)
    assert t.method._proxy is not None
    assert_same_graph(t, j, len(xs))
    for idx, pkg in ((j, tpu_knn), (t, tpu_knn_torch)):
        idx.set_query_time_params(pkg.Params(efSearch=40))
    ref = j.knn_query_batch(qs, 10)
    got = t.knn_query_batch(qs, 10)
    assert_same_knn("cosinesimil_sparse", xs, qs, ref, got)
    pv, r_mat = t.method._proxy[1].vecs, t.method._proxy[2]
    assert t.memory_usage_bytes() >= (pv.numel() + r_mat.numel()) * 4
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / f"{reader.__name__}_reads")
        src.save(path)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        back.set_query_time_params(reader.Params(efSearch=40))
        assert back.method._proxy is not None
        assert_same_knn("cosinesimil_sparse", xs, qs, ref, back.knn_query_batch(qs, 10))
    # without sketchQuery a load draws no R and keeps no proxy
    t2 = index(tpu_knn_torch, "cosinesimil_sparse", xs, "hnsw", PROXY_BUILD)
    t2.save(str(tmp_path / "plain"))
    back = tpu_knn_torch.Index.load(str(tmp_path / "plain"), **CPU)
    assert back.method._proxy is None
    np.testing.assert_array_equal(back.method.graph["level0"].numpy(), t2.method.graph["level0"].numpy())
