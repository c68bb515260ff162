"""Index persistence in tpu_knn's format v3 (counterpart of
tpu_knn/io/persist.py), numpy + JSON only, so a file either package
writes loads in the other.

The reference saves two artifacts: ``<path>.dat`` (space data) and
``<path>`` (method index blob) (nmslib_c.cpp:1369-1397). Format v3 keeps
them as ``<path>.dat.npz`` + ``<path>.idx.npz``. The ``.idx.npz`` holds
the creation header as JSON bytes under ``__header__`` (space, params,
method, kinds, count, mesh size) and the method state as ``state_*``
arrays. The data arrays (``ids``, ``labels``, ``dense``) live in exactly
one artifact: the ``.dat.npz`` when saved with ``save_data=True``,
embedded in the ``.idx.npz`` as ``data_*`` otherwise. The loader uses
embedded arrays when present and the ``.dat.npz`` otherwise, so both
load modes work for both save modes. Format-v1 headers (no embedded
data, no v3 layout) raise :class:`DataIOError`.

Only dense and uint8 stores are ported (the port has no sparse or string
space yet).
"""

from __future__ import annotations

import json

import numpy as np

from ..core.dataset import DataKind, DataStore, DistKind
from ..core.errors import DataIOError
from ..core.params import Params
from ..core.registry import create_method

_FORMAT_VERSION = 3  # v3: data arrays in exactly one artifact (see module doc)


def _store_to_arrays(store: DataStore) -> dict[str, np.ndarray]:
    if store.kind not in (DataKind.DENSE, DataKind.UINT8):
        raise DataIOError(f"saving a {store.kind.value} store is not ported (ROADMAP.md)")
    return {
        "ids": np.asarray(store.ids, np.int64),
        "labels": np.asarray(store.labels, np.int64),
        "dense": store.dense_matrix(),
    }


def _store_from_arrays(kind: DataKind, arrays) -> DataStore:
    if kind not in (DataKind.DENSE, DataKind.UINT8):
        raise DataIOError(f"loading a {kind.value} store is not ported (ROADMAP.md)")
    store = DataStore(kind)
    mat = arrays["dense"]
    if mat.shape[0]:
        ids = arrays["ids"].tolist()
        if kind is DataKind.DENSE:
            store.add_dense_batch(mat, ids)
        else:
            store.add_uint8_batch(mat, ids)
    store.labels = arrays["labels"].tolist()
    return store


def save_index(index, path: str, save_data: bool = True) -> None:
    header = {
        "format_version": _FORMAT_VERSION,
        "space": index._requested_space,
        "space_params": index.space_params.as_dict(),
        "method": index.method_name,
        "data_type": index.data_type.value,
        "dist_type": index.dist_type.value,
        "index_params": (index._index_params or Params()).as_dict(),
        "count": len(index.store),
        "mesh_devices": 0,  # the port has no mesh layer yet
    }
    state = index.method.state_arrays() if index.method is not None else {}
    try:
        data_arrays = _store_to_arrays(index.store)
        # the data arrays go to exactly one artifact (see module doc)
        embed = {} if save_data else {f"data_{k}": v for k, v in data_arrays.items()}
        np.savez(
            path + ".idx.npz",
            __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
            **embed,
            **{f"state_{k}": np.asarray(v) for k, v in state.items()},
        )
        if save_data:
            np.savez(path + ".dat.npz", **data_arrays)
    except OSError as e:
        raise DataIOError(f"failed to save index to {path}: {e}")


def load_index(path: str, load_data: bool = True, device="cuda"):
    """Rebuild the saved index on ``device``. ``load_data`` is accepted for
    the reference's signature: the data arrays are read from whichever
    artifact holds them, in both modes. A header with ``mesh_devices`` > 0
    raises InvalidArgumentError, as ``Index(mesh=...)`` does."""
    from ..api import Index

    try:
        idx_npz = np.load(path + ".idx.npz")
    except OSError as e:
        raise DataIOError(f"failed to load index from {path}: {e}")
    header = json.loads(bytes(idx_npz["__header__"].tobytes()).decode())
    index = Index(
        header["space"],
        Params(header["space_params"]) if header["space_params"] else None,
        header["method"],
        DataKind(header["data_type"]),
        DistKind(header["dist_type"]),
        mesh=header.get("mesh_devices", 0) or None,
        device=device,
    )
    index._index_params = Params(header["index_params"])
    if header["format_version"] < 2:
        raise DataIOError(
            f"{path}.idx.npz is a format-v{header['format_version']} "
            "artifact without embedded data; re-save the index"
        )
    embedded = {k[len("data_"):]: idx_npz[k] for k in idx_npz.files if k.startswith("data_")}
    if embedded:
        dat = embedded
    else:
        # a save_data=True artifact: the data lives only in the .dat
        try:
            dat = np.load(path + ".dat.npz")
        except OSError as e:
            raise DataIOError(f"failed to load index data from {path}: {e}")
    index.store = _store_from_arrays(index.data_type, dat)
    state = {k[len("state_"):]: idx_npz[k] for k in idx_npz.files if k.startswith("state_")}
    index.method = create_method(index.method_name, index.space, index._index_params)
    index.method.restore(index.store, state, index._index_params)
    index.built = True
    return index
