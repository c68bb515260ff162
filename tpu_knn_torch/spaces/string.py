"""String spaces: Levenshtein and normalized Levenshtein (counterpart of
tpu_knn/spaces/string.py; reference: include/space/space_leven.h,
include/space/space_string.h, src/distcomp_edist.cc). Objects are raw
byte strings; leven is an Int space, normleven a Float one (init_spaces.h
registration).

Strings are packed on the host into an i32 byte matrix and lengths
(io/native.pack_strings) and scored by the batched DP of ops/edit.py on
the space's device. Besides ``block`` (queries against shared corpus rows)
the space scores the graph's gathered candidates and the construction
heuristic's pairs with the same DP (``gathered_block``, ``pair_block``),
where tpu_knn vmaps ``block`` over the rows; the distances are exact
integers either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataKind, DataStore, DistKind, StringDeviceData, round_up
from ..core.registry import register_space
from ..ops import edit as E
from .base import Space
from .dense import PAD_TERM


def _pack_strings(strings: list[bytes], n_pad: int, l_mult: int = 8):
    """Byte matrix i32[n_pad, L] and lengths i32[n_pad] (native packer when
    it builds, numpy otherwise); L is the longest string rounded up to 8."""
    from ..io import native

    l_max = round_up(max((len(s) for s in strings), default=1) or 1, l_mult)
    return native.pack_strings(strings, n_pad, l_max)


def as_bytes(points) -> list[bytes]:
    """Query or corpus strings as bytes (str is UTF-8 encoded)."""
    return [p.encode("utf-8") if isinstance(p, str) else bytes(p) for p in points]


class StringSpaceBase(Space):
    data_kind = DataKind.STRING

    @property
    def preferred_chunk(self) -> int:
        """Corpus rows a scan step: tpu_knn's 128 on the CPU, so the scans
        take tpu_knn's routes and tie orders there; 8192 on a card, where
        each DP step is a few launches over the whole block
        (ops/edit.levenshtein_blocked splits it to fit block_elems)."""
        return 8192 if self.device.type == "cuda" else 128

    def encode_dataset(self, store: DataStore, row_multiple: int = 8) -> StringDeviceData:
        strs = store.strings()
        n = len(strs)
        n_pad = round_up(max(n, 1), row_multiple)
        chars, length = _pack_strings(strs, n_pad)
        pad = np.zeros(n_pad, np.float32)
        pad[n:] = PAD_TERM
        ids = np.full(n_pad, -1, np.int32)
        ids[:n] = np.asarray(store.ids, np.int32)
        dev = self.device
        data = StringDeviceData(
            chars=torch.from_numpy(chars).to(dev),
            length=torch.from_numpy(length).to(dev),
            ids=torch.from_numpy(ids).to(dev),
            count=n,
        )
        data.extra["pad"] = torch.from_numpy(pad).to(dev)
        return data

    def encode_queries(self, points) -> dict:
        strs = as_bytes(points)
        chars, length = _pack_strings(strs, len(strs))
        return {"qc": torch.from_numpy(chars).to(self.device), "qlen": torch.from_numpy(length).to(self.device)}

    def slice_data(self, data: StringDeviceData, start: int, size: int) -> dict:
        sl = slice(start, start + size)
        return {"x": data.chars[sl], "len": data.length[sl], "pad": data.extra["pad"][sl]}

    def corpus_dict(self, data: StringDeviceData) -> dict:
        # 'count' lets the gather paths mask padding without a gather
        # (ops/graph._row_pad); a 'row_mask' (sw-graph deletions) overrides it
        c = {"vecs": data.chars, "len": data.length, "pad": data.extra["pad"], "count": data.count}
        if "row_mask" in data.extra:
            c["row_mask"] = data.extra["row_mask"]
        return c

    def block(self, qenc, xc, precision: str = "float32") -> torch.Tensor:
        d = self._finish(E.levenshtein_blocked(qenc["qc"], qenc["qlen"], xc["x"], xc["len"]),
                         qenc["qlen"][:, None], xc["len"][None, :])
        return d + xc["pad"][None, :]

    def gathered_block(self, qenc, rows, pad, extra) -> torch.Tensor:
        """Distances f32[B, K] of query b to its own gathered rows [B, K, L]."""
        d = E.levenshtein_gathered(qenc["qc"], qenc["qlen"], rows, extra["len"])
        return self._finish(d, qenc["qlen"][:, None], extra["len"]) + pad

    def pair_block(self, qe, rows, pad, extra, v_pad=None) -> torch.Tensor:
        """Distances [B, C, C2] of per-row candidate sets (the construction
        heuristic): a-side encodings qc [B, C, L] against rows [B, C2, L]."""
        d = E.levenshtein_pairs(qe["qc"], qe["qlen"], rows, extra["len"])
        return self._finish(d, qe["qlen"][:, :, None], extra["len"][:, None, :]) + pad[:, None, :]

    def _finish(self, d, qlen, xlen) -> torch.Tensor:
        """The space's f32 distance from the integer edit distances."""
        raise NotImplementedError


@register_space("leven")
class LevenSpace(StringSpaceBase):
    name = "leven"
    dist_kind = DistKind.INT

    def _finish(self, d, qlen, xlen):
        return d.to(torch.float32)


@register_space("normleven")
class NormLevenSpace(StringSpaceBase):
    name = "normleven"
    dist_kind = DistKind.FLOAT

    def _finish(self, d, qlen, xlen):
        return E.normalize(d, qlen, xlen)
