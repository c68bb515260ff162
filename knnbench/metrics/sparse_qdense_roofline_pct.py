"""sparse_qdense_roofline_pct (%): the sparse scan kernel's least time over
its device time, summed over the batches of the traced window. A batch's
least time (knnbench/roofline.py) is the larger of its bytes (the corpus
and query CSR once at 8 bytes a stored non-zero, the Q x N f32 distances
once) at 3.35 TB/s and 2 x its matching (query term, row term) products at
67 TFLOP/s; the products are counted here from the benchmark's own inputs:
for each query term, the rows that hold it."""

from collections import Counter

import numpy as np

from knnbench.roofline import sparse_qdense_least_s

KERNEL = "sparse_qdense_kernel"


def read(run):
    t = run.trace
    if t is None or run.inputs.kind != "sparse":
        return None
    busy = sum(e - s for n, s, e in t.kernels() if KERNEL in n)
    if busy <= 0:
        return None
    _, cols, _ = run.inputs.corpus
    qptr, qcols, _ = run.inputs.queries
    rows_of_term = np.bincount(cols, minlength=run.inputs.vocab)
    least = 0.0
    for b, times in Counter(run.pool_index).items():
        s, e = run.inputs.batch_rows(b)
        lo, hi = int(qptr[s]), int(qptr[e])
        products = int(rows_of_term[qcols[lo:hi]].sum())
        least += times * sparse_qdense_least_s(products, len(cols), hi - lo, e - s, run.inputs.n)[0]
    return 100.0 * least / busy
