"""issue_host_ms (ms): host time a batch that the port takes to issue the
batch's device work, read from its spans (tpu_knn_torch/utils/tracing.py):
the dispatcher worker's ``dispatcher.run`` (kNN), or range's
``seq_search.range_count`` and ``seq_search.range_collect``, less the
``sync.*`` spans (device-to-host waits) inside them. None where the
program has no such spans.

It counts the time the host is held in a launch while the card's launch
queue is full, which no span can tell apart. So where the queue stays full
(the sparse scan's 2,537 launches a batch) it reads the card's pace, not
the host's work, and its cells leave such a traffic out."""

ROOTS = ("dispatcher.run", "seq_search.range_count", "seq_search.range_collect")


def read(run):
    try:
        from tpu_knn_torch.utils import tracing
    except ImportError:
        return None
    records = tracing.spans()
    by_id = {r.id: r for r in records}

    def root(r):
        """The outermost span of ROOTS that holds ``r`` (itself included), or None."""
        found = None
        while r is not None:
            if r.name in ROOTS:
                found = r
            r = by_id.get(r.parent)
        return found

    ns, seen = 0, False
    for r in records:
        if r.name in ROOTS and root(r) is r:
            ns += r.host_ns
            seen = True
        elif r.name.startswith("sync.") and root(r) is not None:
            ns -= r.host_ns
    if not seen or not run.latencies:
        return None
    return ns * 1e-6 / len(run.latencies)
