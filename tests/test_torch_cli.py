"""The port's experiment CLI (tpu_knn_torch.cli, --device cpu) against
tpu_knn's on tests/test_cli.py's 200 x 12 data: both mains in-process
print the same quality columns (all but qps), raise the same error
classes, and an index either CLI saves loads in the other; one
subprocess proves ``python -m tpu_knn_torch``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn.cli as JC  # noqa: E402
import tpu_knn_torch  # noqa: E402
import tpu_knn_torch.cli as TC  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--spaceType", "l2", "--spaceParams", "dim=12"]


@pytest.fixture(autouse=True)
def _no_jit_cache(monkeypatch):
    monkeypatch.setenv("TPU_KNN_JIT_CACHE", "0")  # tpu_knn's main would enable it


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(42)
    data, queries = d / "data.txt", d / "queries.txt"
    np.savetxt(data, rng.standard_normal((200, 12)).astype(np.float32), fmt="%.5f")
    np.savetxt(queries, rng.standard_normal((16, 12)).astype(np.float32), fmt="%.5f")
    return d, str(data), str(queries)


def _tables(path: str) -> dict:
    """{title: [row dicts]} of a result file; qps (a timing) dropped."""
    out, title, head = {}, None, None
    for line in open(path).read().splitlines():
        if line.startswith("=== "):
            title, head = line.strip("= "), None
            out[title] = []
        elif title and line and not line.startswith("-"):
            cells = line.split("  ")
            cells = [c.strip() for c in cells if c.strip()]
            if head is None:
                head = cells
            else:
                row = dict(zip(head, cells))
                row.pop("qps", None)
                out[title].append(row)
    return out


def _run_both(tmp_path, argv):
    res = []
    for name, main, dev in (("j", JC.main, []), ("t", TC.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.txt")
        assert main(argv + ["--outFile", out] + dev) == 0
        res.append(_tables(out))
    return res


@pytest.mark.parametrize("method,extra", [
    ("seq_search", ["--knn", "3,5", "--range", "3.5", "--testSetQty", "2", "--maxNumQuery", "20"]),
    ("hnsw", ["--createIndex", "M=8,efConstruction=40,waveSize=32", "--queryTimeParams", "efSearch=10",
              "--queryTimeParams", "efSearch=40", "--knn", "5", "--testSetQty", "1", "--maxNumQuery", "30"]),
])
def test_cli_quality_columns_equal(tmp_path, files, method, extra):
    _, data, _ = files
    j, t = _run_both(tmp_path, BASE + ["--dataFile", data, "--method", method] + extra)
    assert j == t and j
    if method == "seq_search":
        assert all(r["recall"] == "1" for rows in t.values() for r in rows)


@pytest.mark.parametrize("argv", [
    BASE + ["--distType", "int", "--knn", "3"],
    BASE + ["--knn", "3", "--saveIndex", "never"],
    BASE + ["--knn", "3", "--loadIndex", "never"],
], ids=["distType_mismatch", "save_without_queryFile", "load_without_queryFile"])
def test_cli_errors_same_class(files, argv):
    _, data, _ = files
    names = []
    for main, dev in ((JC.main, []), (TC.main, ["--device", "cpu"])):
        with pytest.raises(Exception) as info:
            main(argv + ["--dataFile", data] + dev)
        names.append(type(info.value).__name__)
    assert names[0] == names[1] == "InvalidArgumentError"


def test_cli_device_flags(files, monkeypatch):
    """--platform is a synonym of --device; tpu has no device here; cuda
    without a card fails (no fallback)."""
    from tpu_knn_torch.core.errors import InvalidArgumentError

    _, data, _ = files
    argv = BASE + ["--dataFile", data, "--knn", "3", "--maxNumQuery", "10", "--method", "seq_search"]
    assert TC.main(argv + ["--platform", "cpu", "--outFile", os.devnull]) == 0
    with pytest.raises(InvalidArgumentError, match="platform"):
        TC.main(argv + ["--platform", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--device", "cuda"], [], ["--platform", "gpu"]):
        with pytest.raises(InvalidArgumentError, match="cuda"):
            TC.main(argv + flags)


@pytest.mark.parametrize("writer", ["tpu_knn", "port"])
def test_cli_saved_index_loads_in_other(tmp_path, files, writer):
    """An hnsw index saved by one CLI (--saveIndex with --queryFile) loads in
    the other package, and through the other CLI's --loadIndex, with equal
    results and quality columns."""
    _, data, queries = files
    argv = BASE + ["--dataFile", data, "--queryFile", queries, "--method", "hnsw",
                   "--createIndex", "M=8,efConstruction=40,waveSize=32", "--queryTimeParams", "efSearch=20",
                   "--knn", "5"]
    path = str(tmp_path / "ix")
    wmain, wdev = (JC.main, []) if writer == "tpu_knn" else (TC.main, ["--device", "cpu"])
    rmain, rdev = (TC.main, ["--device", "cpu"]) if writer == "tpu_knn" else (JC.main, [])
    w_out, r_out = str(tmp_path / "w.txt"), str(tmp_path / "r.txt")
    assert wmain(argv + ["--saveIndex", path, "--outFile", w_out] + wdev) == 0
    assert rmain(argv + ["--loadIndex", path, "--outFile", r_out] + rdev) == 0
    assert _tables(w_out) == _tables(r_out)
    q = np.loadtxt(queries, dtype=np.float32)
    a = tpu_knn.Index.load(path)
    a.set_query_time_params(tpu_knn.Params(efSearch=20))
    b = tpu_knn_torch.Index.load(path, device="cpu")
    b.set_query_time_params(tpu_knn_torch.Params(efSearch=20))
    da, ia = a.knn_query_batch(q, 5)
    db, ib = b.knn_query_batch(q, 5)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=5e-3, atol=1e-5)


def test_python_m_entry_point(files):
    _, data, _ = files
    out = os.path.join(files[0], "sub.txt")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_knn_torch", *BASE, "--dataFile", data, "--method", "seq_search",
         "--knn", "3", "--testSetQty", "1", "--maxNumQuery", "20", "--device", "cpu", "--outFile", out],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = _tables(out)["kNN k=3 (method=seq_search, space=l2)"]
    assert rows[0]["recall"] == "1"
