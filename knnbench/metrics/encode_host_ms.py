"""encode_host_ms (ms): host self time a batch of the port's
``spaces.encode`` span (tpu_knn_torch/utils/tracing.py): the queries
packed and copied to the card on the caller's thread. None where the
program has no such span."""


def read(run):
    try:
        from tpu_knn_torch.utils import tracing
    except ImportError:
        return None
    t = tracing.totals().get("spaces.encode")
    if t is None or not run.latencies:
        return None
    return t["self_ms"] / len(run.latencies)
