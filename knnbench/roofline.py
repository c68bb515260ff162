"""Peaks of one NVIDIA H100 SXM and the least time of the port's kernels.

The peaks are NVIDIA's published dense rates (data sheet, SXM part, at the
700 W power limit). A kernel's least time is the larger of its operations
over the peak and its bytes over HBM's rate, counting each input byte read
once and each output byte written once, and counting the work that these
inputs need, not the most the kernel could do. A roofline share is that
least time over the measured time; it cannot pass 100% unless the work is
counted too high or the time leaves part of it out.
"""

from __future__ import annotations

#: FLOP/s of the FP32 pipe outside the tensor cores (an FMA counts 2)
FP32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def groupmin_f32_least_s(q: int, n: int, d: int) -> tuple[float, str]:
    """One ``groupmin_f32`` launch (csrc/groupmin.cu): the f32 group mins
    [q, n/128] of q x n distances of depth d. 2 q n d operations; q and x
    in f32, a row term for each, and the mins written once."""
    nbytes = 4 * (q * d + n * d) + 4 * (q + n) + 4 * q * (n // 128)
    return least_s(2.0 * q * n * d, nbytes)


def sparse_qdense_least_s(products: int, corpus_nnz: int, query_nnz: int, q: int, n: int) -> tuple[float, str]:
    """The sparse scan's kernel (csrc/sparse_qdense.cu) over a batch: 2
    operations a matching (query term, row term) product; the corpus and
    query CSR read once at 8 bytes a stored non-zero (id and weight), and
    the q x n f32 distances written once."""
    return least_s(2.0 * products, 8.0 * (corpus_nnz + query_nnz) + 4.0 * q * n)
