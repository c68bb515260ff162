"""qps (queries/s): every query answered in the window over the window's
seconds, dispatch of the first batch to the answer of the last (host
clock)."""


def read(run):
    return run.queries_done / run.window_s if run.window_s > 0 and run.queries_done else None
