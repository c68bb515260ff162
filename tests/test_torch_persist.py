"""Persistence in format v3 across the two packages: files the port writes
load in tpu_knn and files tpu_knn writes load in the port, in both save
and both load modes, with equal headers, array names and results."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.core.errors import DataIOError, InvalidArgumentError  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402

PKGS = {"tpu_knn": (tpu_knn, {}), "port": (tpu_knn_torch, {"device": "cpu"})}


def _build(name, space, x, params, ids=None, labels=None):
    pkg, kw = PKGS[name]
    if space == "l2sqr_sift":
        idx = pkg.Index(space, None, "seq_search", "dense_uint8_vector", "int", **kw)
        idx.add_uint8_batch(x, ids=ids)
    else:
        idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), "seq_search", **kw)
        idx.add_dense_batch(x, ids=ids, labels=labels)
    idx.build_index(pkg.Params(params))
    return idx


def _load(name, path, load_data):
    pkg, kw = PKGS[name]
    return pkg.Index.load(path, load_data=load_data, **kw)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _header(path):
    return json.loads(bytes(_npz(path + ".idx.npz")["__header__"].tobytes()).decode())


@pytest.mark.parametrize("load_data", [True, False])
@pytest.mark.parametrize("save_data", [True, False])
@pytest.mark.parametrize("writer,reader", [("port", "tpu_knn"), ("tpu_knn", "port")])
def test_files_cross_packages(tmp_path, writer, reader, save_data, load_data):
    x = clustered(5000, 16, seed=51)
    q = clustered(9, 16, seed=52)
    ids = np.arange(5000) * 2 + 5
    labels = np.arange(5000) % 7
    params = {"chunkSize": 1024}
    src = _build(writer, "l2", x, params, ids=ids, labels=labels)
    d0, i0 = src.knn_query_batch(q, 3)
    p = str(tmp_path / "ix")
    src.save(p, save_data=save_data)
    assert os.path.exists(p + ".dat.npz") == save_data
    dst = _load(reader, p, load_data)
    assert dst.data_qty() == 5000 and dst.get_space_type() == "l2"
    assert dst._index_params == PKGS[reader][0].Params(params)
    assert dst.store.ids == ids.tolist() and dst.store.labels == labels.tolist()
    d1, i1 = dst.knn_query_batch(q, 3)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(d1, d0, rtol=5e-3, atol=1e-5)
    np.testing.assert_array_equal(dst.get_data_point(17), x[17])


@pytest.mark.parametrize("save_data", [True, False])
@pytest.mark.parametrize("space", ["l2", "cosine", "l2sqr_sift"])
def test_same_header_and_arrays_as_tpu_knn(tmp_path, space, save_data):
    """Both packages write the same header and the same array names, with
    equal contents; the requested space name ("cosine") round-trips."""
    if space == "l2sqr_sift":
        x = np.random.default_rng(53).integers(0, 256, (300, 128)).astype(np.uint8)
    else:
        x = clustered(300, 12, seed=53)
    files = {}
    for name in PKGS:
        p = str(tmp_path / name)
        _build(name, space, x, {"chunkSize": 64}).save(p, save_data=save_data)
        files[name] = p
    hj, ht = _header(files["tpu_knn"]), _header(files["port"])
    assert hj == ht and ht["format_version"] == 3 and ht["mesh_devices"] == 0
    assert ht["space"] == space and ht["index_params"] == {"chunkSize": 64}
    for suffix in (".idx.npz", ".dat.npz") if save_data else (".idx.npz",):
        aj, at = _npz(files["tpu_knn"] + suffix), _npz(files["port"] + suffix)
        assert sorted(aj) == sorted(at)
        for key in aj:
            assert aj[key].dtype == at[key].dtype, key
            np.testing.assert_array_equal(at[key], aj[key])
    idx = _load("port", files["tpu_knn"], True)
    assert idx.get_space_type() == space and idx.space_name == hj["space"].replace("cosine", "cosinesimil")
    if space != "l2sqr_sift":
        q = x[:4] + 0.01
        np.testing.assert_array_equal(idx.knn_query_batch(q, 2)[1],
                                      _load("tpu_knn", files["port"], True).knn_query_batch(q, 2)[1])


def test_v1_header_raises(tmp_path):
    header = {
        "format_version": 1, "space": "l2", "space_params": {"dim": 4}, "method": "seq_search",
        "data_type": "dense_vector", "dist_type": "float", "index_params": {}, "count": 0,
    }
    p = str(tmp_path / "old")
    np.savez(p + ".idx.npz", __header__=np.frombuffer(json.dumps(header).encode(), np.uint8))
    for name in PKGS:
        with pytest.raises(DataIOError if name == "port" else tpu_knn.DataIOError, match="format-v1"):
            _load(name, p, True)


def test_mesh_header_and_missing_files_raise(tmp_path):
    """A header with mesh_devices=4 loads onto a 4-shard mesh of the load's
    device with the single index's results; missing files raise."""
    from tpu_knn_torch.parallel.sharded import DistributedSeqSearch

    x = clustered(50, 4, seed=54)
    p = str(tmp_path / "m")
    single = _build("port", "l2", x, {})
    single.save(p)
    z = _npz(p + ".idx.npz")
    h = json.loads(bytes(z["__header__"].tobytes()).decode())
    h["mesh_devices"] = 4
    z["__header__"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    np.savez(p + ".idx.npz", **z)
    sharded = tpu_knn_torch.Index.load(p, device="cpu")
    assert isinstance(sharded.method, DistributedSeqSearch) and sharded.mesh.size == 4
    d0, i0 = single.knn_query_batch(x[:5], 3)
    d1, i1 = sharded.knn_query_batch(x[:5], 3)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(d1, d0, rtol=5e-3, atol=1e-5)
    sharded.save(p + "2")
    assert _header(p + "2")["mesh_devices"] == 4
    with pytest.raises(DataIOError):
        tpu_knn_torch.Index.load(str(tmp_path / "nothing"), device="cpu")
    os.remove(p + ".dat.npz")
    h["mesh_devices"] = 0
    z["__header__"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    np.savez(p + ".idx.npz", **z)
    with pytest.raises(DataIOError, match="index data"):
        tpu_knn_torch.Index.load(p, device="cpu")


def test_load_device(tmp_path, monkeypatch):
    """The port loads onto the device it is given; "cuda", the default,
    raises without a card instead of falling back to the CPU."""
    x = clustered(100, 8, seed=55)
    p = str(tmp_path / "d")
    _build("port", "l2", x, {}).save(p)
    idx = tpu_knn_torch.Index.load(p, device="cpu")
    assert idx.device.type == "cpu" and idx.built and idx.method.data.vecs.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidArgumentError, match="cuda"):
        tpu_knn_torch.Index.load(p)


def test_save_auto_builds_and_empty_state(tmp_path):
    """save() builds an unbuilt index first; seq_search keeps no state
    arrays, so restore() rebuilds from the data."""
    x = clustered(40, 8, seed=56)
    idx = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=8), "seq_search", device="cpu")
    idx.add_dense_batch(x)
    assert not idx.built
    p = str(tmp_path / "s")
    idx.save(p)
    assert idx.built and idx.method.state_arrays() == {}
    assert not any(k.startswith("state_") for k in _npz(p + ".idx.npz"))
    back = tpu_knn_torch.Index.load(p, device="cpu")
    assert back.knn_query(x[3], 1).ids.tolist() == [3]
