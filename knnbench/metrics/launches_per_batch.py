"""launches_per_batch (launches): kernels the card ran in the traced window
(copies and fills left out) over the batches answered in it: the host's
issue work a batch, through the API and the dispatcher."""


def read(run):
    t = run.trace
    if t is None or not run.latencies:
        return None
    n = len(t.kernels())
    return n / len(run.latencies) if n else None
