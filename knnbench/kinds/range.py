"""kind ``range``: ``Index.range_query_batch``, closed loop, one client,
one batch at a time (the port has no asynchronous range entry). Traffic
key ``radius``: ``{"kth": j, "quantile": p}``, the p-quantile over the
pool of each query's j-th neighbour distance, worked out by the reference
before the index is built."""

import time

from knnbench.reference import Reference


def prepare(cell, inputs, device) -> dict:
    if "in_flight" in cell.traffic:
        raise ValueError(f"traffic {cell.traffic}: range runs one batch at a time; in_flight is not read")
    rad = cell.traffic["radius"]
    ref = Reference(inputs, cell.config["space"], device)
    return {"radius": ref.radius(int(rad["kth"]), float(rad["quantile"]))}


def drive(idx, batches, traffic, args, more, tally) -> list:
    """As ``knn.drive``; each answer a list of (ids, dists) a query."""
    pool, out, i = len(batches), [], 0
    while more(i):
        b = i % pool
        i += 1
        tally.attempted += len(batches[b])
        t = time.perf_counter()
        try:
            ans = [(r.ids, r.dists) for r in idx.range_query_batch(batches[b], args["radius"])]
        except Exception:  # noqa: BLE001 - a failed batch is counted, and the run goes on
            tally.fail(len(batches[b]))
            ans = None
        out.append((b, t, time.perf_counter(), ans))
    return out


def exact(reference, answers, traffic, args) -> dict:
    return reference.range(answers, args["radius"])


def control(reference, traffic, args) -> dict:
    return reference.control_range(args["radius"])
