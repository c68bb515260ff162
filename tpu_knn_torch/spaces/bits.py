"""Bit-vector spaces: ``bit_hamming`` (Int) and ``bit_jaccard`` (Float)
(counterpart of tpu_knn/spaces/bits.py; reference:
include/space/space_bit_hamming.h, space_bit_jaccard.h, distcomp.h:226-250
popcount kernels).

The reference packs bits into u32 words and popcounts. Here the bits are
unpacked to f32 0/1 rows once, at encode, and for 0/1 vectors

    hamming(q, x) = |q| + |x| - 2 <q, x>
    jaccard(q, x) = 1 - <q, x> / (|q| + |x| - <q, x>)

so one IEEE f32 product of the unpacked rows (exact below 2^24 bits)
replaces the per-pair word loop. ``bit_hamming`` has that affine form, so
the exact scan's pass 1 runs the f32 group-min kernel (csrc/groupmin.cu)
on the 0/1 rows; the rows are f32, never int8, so the int8 tier
(``l2sqr_sift`` only) is never reached. ``bit_jaccard`` has no affine form
and takes the block route. Data arrives as dense uint8 0/1 rows through
``add_uint8_batch``, or packed through ``Index.add_bit_batch_packed``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataKind, DistKind
from ..core.errors import InvalidArgumentError
from ..core.registry import register_space
from ..ops import distance as D
from .dense import DenseSpace


def unpack_bit_vectors(words, n_bits: int | None = None) -> np.ndarray:
    """Unpack reference-format packed bit vectors into 0/1 uint8 rows.

    ``words``: uint32 [n, w] where bit j of word i is element 32*i + j
    (the reference's object layout, space_bit_hamming.h:43-52 /
    space_bit_vector.h, WITHOUT the trailing element-count word the
    reference appends to each object). ``n_bits`` drops the tail padding
    of the last word (default keeps all 32*w columns).
    """
    w = np.ascontiguousarray(np.asarray(words))
    if w.ndim != 2 or w.dtype.kind != "u" or w.dtype.itemsize != 4:
        raise InvalidArgumentError("packed bit vectors must be uint32 [n, words]")
    w = w.astype("<u4", copy=False)  # i*32+j element order needs LE bytes
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[0], -1), axis=1, bitorder="little")
    if n_bits is not None:
        if not 0 < n_bits <= 32 * w.shape[1]:
            raise InvalidArgumentError(f"n_bits={n_bits} out of range for {w.shape[1]} packed words")
        if np.any(bits[:, n_bits:]):
            raise InvalidArgumentError("padding bits beyond n_bits must be zero")
        bits = bits[:, :n_bits]
    return bits


class BitSpaceBase(DenseSpace):
    """0/1 rows as f32; the per-row term is the row's popcount, exact in
    any summation order."""

    data_kind = DataKind.UINT8
    term_recompute = True

    def term_from_rows(self, rows):
        return torch.sum(rows, dim=-1)

    def _transform_x(self, v):
        b = np.asarray(v, np.float32)
        if np.any((b != 0) & (b != 1)):
            raise InvalidArgumentError(f"{self.name} requires 0/1 bit vectors")
        return b

    _transform_q = _transform_x

    def _term_q(self, v):
        return torch.sum(v.to(torch.float32), dim=1)


@register_space("bit_hamming")
class BitHammingSpace(BitSpaceBase):
    name = "bit_hamming"
    dist_kind = DistKind.INT

    def pass1_affine(self):
        return (-2.0, 1.0, 1.0)

    def pass1_post(self, s, qenc):
        return torch.clamp_min(s, 0.0)

    def _block_impl(self, qenc, xc, precision):
        d = D.factored(qenc["q"], xc["x"], qenc["q_term"], xc["x_term"], scale=-2.0, precision=precision)
        return torch.clamp_min(d, 0.0)


@register_space("bit_jaccard")
class BitJaccardSpace(BitSpaceBase):
    name = "bit_jaccard"
    dist_kind = DistKind.FLOAT

    def _block_impl(self, qenc, xc, precision):
        inter = D.matmul(qenc["q"], xc["x"], precision)
        union = qenc["q_term"][:, None] + xc["x_term"][None, :] - inter
        return torch.where(union > 0, 1.0 - inter / torch.clamp_min(union, 1.0), 0.0)
