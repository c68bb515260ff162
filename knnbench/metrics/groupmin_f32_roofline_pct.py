"""groupmin_f32_roofline_pct (%): the pass-1 kernel's least time over its
mean device time a launch. The least time is that of one launch over the
batch's queries, the corpus's rows and their width (knnbench/roofline.py:
2 Q N D operations at 67 TFLOP/s, or q, x, the row terms and the group
mins once at 3.35 TB/s, whichever is larger)."""

from knnbench.roofline import groupmin_f32_least_s

KERNEL = "groupmin_f32_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [e - s for n, s, e in t.kernels() if KERNEL in n]
    if not times:
        return None
    least, _ = groupmin_f32_least_s(run.inputs.batch, run.inputs.n, int(run.cell.config["dim"]))
    return 100.0 * least * len(times) / sum(times)
