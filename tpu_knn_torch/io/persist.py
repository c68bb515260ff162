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

A sparse store is saved as its row lengths, concatenated element ids and
values (``sparse_len``, ``sparse_ids``, ``sparse_vals``), a string store as
its byte lengths and concatenated UTF-8 bytes (``str_len``, ``str_bytes``),
as tpu_knn saves them. The ``state_*`` arrays are the method's
``state_arrays()`` under tpu_knn's names: HNSW's levels (and sw-graph's
int8 ``deleted`` mask), VP-tree's ``pivot_pos``, ``medians``,
``leaf_members``, ``leaf_of``, ``leaf_count`` and ``meta``, NAPP's pivots
and prefixes.
"""

from __future__ import annotations

import json

import numpy as np

from ..core.dataset import DataKind, DataStore, DistKind
from ..core.errors import DataIOError
from ..core.params import Params

_FORMAT_VERSION = 3  # v3: data arrays in exactly one artifact (see module doc)


def _store_to_arrays(store: DataStore) -> dict[str, np.ndarray]:
    out = {"ids": np.asarray(store.ids, np.int64), "labels": np.asarray(store.labels, np.int64)}
    if store.kind is DataKind.STRING:
        bs = store.strings()
        out["str_len"] = np.asarray([len(b) for b in bs], np.int64)
        out["str_bytes"] = np.frombuffer(b"".join(bs), dtype=np.uint8) if bs else np.zeros(0, np.uint8)
    elif store.kind is DataKind.SPARSE:
        pts = store.sparse_points()
        out["sparse_len"] = np.asarray([len(p.ids) for p in pts], np.int64)
        out["sparse_ids"] = np.concatenate([p.ids for p in pts]) if pts else np.zeros(0, np.int32)
        out["sparse_vals"] = np.concatenate([p.values for p in pts]) if pts else np.zeros(0, np.float32)
    else:
        out["dense"] = store.dense_matrix()
    return out


def _store_from_arrays(kind: DataKind, arrays) -> DataStore:
    store = DataStore(kind)
    ids = arrays["ids"].tolist()
    if kind is DataKind.STRING:
        raw = arrays["str_bytes"].tobytes()
        ends = np.cumsum(arrays["str_len"])
        strs = [raw[e - n:e] for n, e in zip(arrays["str_len"].tolist(), ends.tolist())]
        if strs:
            store.add_string_batch(strs, ids)
    elif kind is DataKind.SPARSE:
        sids, svals = arrays["sparse_ids"], arrays["sparse_vals"]
        ends = np.cumsum(arrays["sparse_len"])
        pts = [(sids[e - n:e], svals[e - n:e]) for n, e in zip(arrays["sparse_len"], ends)]
        if pts:
            store.add_sparse_batch(pts, ids)
    else:
        mat = arrays["dense"]
        if mat.shape[0]:
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
        # a sharded index records its mesh size; load recreates an
        # equal-size mesh on the load's device
        "mesh_devices": (
            int(index.mesh.devices.size)
            if getattr(index, "mesh", None) is not None and not isinstance(index.mesh, int)
            else int(index.mesh or 0)
        ),
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
    loads onto a mesh of that many shards of ``device``'s type."""
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
    index.method = index._make_method(index._index_params)
    index.method.restore(index.store, state, index._index_params)
    index.built = True
    return index
