"""check ``exact``: every answer of the window against a float64 scan of the
same inputs, up to the float32 error bound of each pair (reference.py):
the traffic kind's ``exact`` comparison. Each number is the worst over all
answers; the limits are ``knnbench/limits/<cell>.json``."""


def numbers(run) -> dict:
    return run.kind.exact(run.reference, run.answers, run.cell.traffic, run.args)
