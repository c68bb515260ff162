"""api_host_ms (ms): host time a batch in the port's API itself, read from
its spans (tpu_knn_torch/utils/tracing.py): the self time of
``api.knn_async``, ``api.result``, ``api.knn`` and ``api.range``
(validation, bucketing, the sparse points' checks, the answers'
conversion), without their children (``api.wait``, ``spaces.*``,
``seq_search.*``, ``sync.*``). None where the program has no such spans."""

NAMES = ("api.knn_async", "api.result", "api.knn", "api.range")


def read(run):
    try:
        from tpu_knn_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    found = [totals[n]["self_ms"] for n in NAMES if n in totals]
    if not found or not run.latencies:
        return None
    return sum(found) / len(run.latencies)
