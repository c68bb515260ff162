"""kind ``knn``: ``Index.knn_query_batch_async``, closed loop, one client,
``in_flight`` batches outstanding (default 1), each dispatched as soon as
one returns. Traffic keys: ``k``, ``in_flight``."""

import time
from collections import deque


def prepare(cell, inputs, device) -> dict:
    """Nothing to work out before the index: no arguments besides ``k``."""
    return {}


def drive(idx, batches, traffic, args, more, tally) -> list:
    """Batches dispatched while ``more(i)`` holds for the i-th; returns
    (pool batch, dispatch time, answer time, (dists, ids) or None) of each."""
    k, in_flight, pool = int(traffic["k"]), int(traffic.get("in_flight", 1)), len(batches)
    pending, out, i = deque(), [], 0
    while True:
        while len(pending) < in_flight and more(i):
            b = i % pool
            i += 1
            tally.attempted += len(batches[b])
            t = time.perf_counter()
            try:
                pending.append((b, t, idx.knn_query_batch_async(batches[b], k)))
            except Exception:  # noqa: BLE001 - a failed batch is counted, and the run goes on
                tally.fail(len(batches[b]))
        if not pending:
            return out
        b, t, fut = pending.popleft()
        try:
            ans = fut.result()
        except Exception:  # noqa: BLE001
            tally.fail(len(batches[b]))
            ans = None
        out.append((b, t, time.perf_counter(), ans))


def exact(reference, answers, traffic, args) -> dict:
    return reference.knn(answers, int(traffic["k"]))


def control(reference, traffic, args) -> dict:
    return reference.control_knn(int(traffic["k"]))
