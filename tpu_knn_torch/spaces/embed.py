"""word_embed space (counterpart of tpu_knn/spaces/embed.py; reference:
include/space/space_word_embed.h, src/space/space_word_embed.cc).

Objects are text lines "word v1 v2 ... vd" (the reference's on-disk
format, ReadNextObjStr): the word is an external identifier, the vector
is the payload, and the distance is L2 or cosine on the vectors. The
required ``dist`` parameter selects the metric
(factory/space/space_word_embed.h: "l2" | "cosine"); an optional
``file`` parameter preloads a whole embedding file so that queries can
be bare words. Lines parse on the host; every tensor operation is the
inner dense space's (spaces/dense.py), on the space's device.
"""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataKind, DataStore, DistKind
from ..core.errors import DataIOError, InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_space
from .base import Space
from .dense import CosineSpace, L2Space


def parse_embed_line(line: str | bytes) -> tuple[str, np.ndarray]:
    if isinstance(line, bytes):
        line = line.decode("utf-8")
    parts = line.split()
    if len(parts) < 2:
        raise InvalidArgumentError(f"word_embed line needs 'word v1 ...': {line[:60]!r}")
    try:
        vec = np.asarray([float(p) for p in parts[1:]], np.float32)
    except ValueError as e:
        raise InvalidArgumentError(f"bad embedding vector in {line[:60]!r}: {e}")
    return parts[0], vec


@register_space("word_embed")
class WordEmbedSpace(Space):
    name = "word_embed"
    data_kind = DataKind.STRING
    dist_kind = DistKind.FLOAT
    preferred_chunk = 8192

    def __init__(self, params: Params | None = None, device="cpu"):
        super().__init__(params, device)
        pm = ParamManager(self.params)
        dist = pm.get("dist", None, str)
        fname = pm.get("file", None, str)
        pm.check_unused()
        if dist is None:
            raise InvalidArgumentError("word_embed requires a 'dist' parameter")
        dist = dist.lower()
        if dist not in ("l2", "cosine"):
            raise InvalidArgumentError(f"Unsupported/unknown distance type for embeddings: '{dist}'")
        self.dist = dist
        inner = L2Space if dist == "l2" else CosineSpace
        self._inner = inner(Params(), device=device)
        self._table: dict[str, np.ndarray] = {}
        if fname:
            self._load_file(fname)

    def _load_file(self, fname: str) -> None:
        try:
            with open(fname, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        w, v = parse_embed_line(line)
                        self._table[w] = v
        except OSError as e:
            raise DataIOError(f"Cannot open file: '{fname}' for reading: {e}")

    # -- conversion: word lines -> vectors --
    def _vectors(self, points) -> np.ndarray:
        vecs = []
        for p in points:
            s = p.decode("utf-8") if isinstance(p, bytes) else str(p)
            if " " in s.strip() or "\t" in s:
                w, v = parse_embed_line(s)
                self._table.setdefault(w, v)
                vecs.append(v)
            else:
                if s not in self._table:
                    raise InvalidArgumentError(f"unknown word {s!r} (no embedding)")
                vecs.append(self._table[s])
        if not vecs:
            return np.zeros((0, 1), np.float32)
        d0 = len(vecs[0])
        if any(len(v) != d0 for v in vecs):
            raise InvalidArgumentError("embedding dimensions differ across words")
        return np.stack(vecs)

    def _dense_store(self, store: DataStore) -> DataStore:
        ds = DataStore(DataKind.DENSE)
        mat = self._vectors(store.strings())
        if mat.shape[0]:
            ds.add_dense_batch(mat, store.ids)
        return ds

    # -- Space interface: delegate to the dense metric --
    def encode_dataset(self, store: DataStore, row_multiple: int = 8):
        return self._inner.encode_dataset(self._dense_store(store), row_multiple)

    def encode_queries(self, points):
        return self._inner.encode_queries(self._vectors(points))

    def slice_data(self, data, start, size):
        return self._inner.slice_data(data, start, size)

    def corpus_dict(self, data):
        return self._inner.corpus_dict(data)

    def block(self, qenc, xc, precision: str = "float32"):
        return self._inner.block(qenc, xc, precision)

    # Scoring hooks read by the graph code (gather-scored beam search) and
    # the two-pass exact scan. They mirror the inner metric: corpus_dict is
    # delegated (so L2's term_recompute=True omits 'term'), and without the
    # matching hooks here the gather paths would see term_recompute=False,
    # inject no x_term and fail in the inner block, while cosine would lose
    # its affine pass 1 on the group-min kernel.
    @property
    def term_recompute(self) -> bool:
        return self._inner.term_recompute

    def term_from_rows(self, rows):
        return self._inner.term_from_rows(rows)

    def pass1_affine(self):
        return self._inner.pass1_affine()

    def pass1_post(self, s, qenc):
        return self._inner.pass1_post(s, qenc)
