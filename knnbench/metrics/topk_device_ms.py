"""topk_device_ms (ms): device time a batch in sort and top-k kernels: the
exact scan's group selection and pass 2's top-k, the sparse scan's merges,
range's collect pass. A kernel counts when its name holds one of PATTERNS
(case aside)."""

PATTERNS = ("sort", "topk")


def read(run):
    t = run.trace
    if t is None or not run.latencies:
        return None
    hits = [e - s for n, s, e in t.kernels() if any(p in n.lower() for p in PATTERNS)]
    return 1e3 * sum(hits) / len(run.latencies) if hits else None
