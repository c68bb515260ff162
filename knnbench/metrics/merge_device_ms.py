"""merge_device_ms (ms): device time a batch of the chunk loop's top-k
merges (the sparse scan's, range's collect pass's), from the CUDA events of
the port's ``seq_search.merge`` spans (tpu_knn_torch/utils/tracing.py).
None where the program has no such span or it has no device time."""


def read(run):
    try:
        from tpu_knn_torch.utils import tracing
    except ImportError:
        return None
    t = tracing.totals().get("seq_search.merge")
    if t is None or t["device_ms"] is None or not run.latencies:
        return None
    return t["device_ms"] / len(run.latencies)
