"""device_idle_pct (%): the share of the traced window in which no kernel,
copy or fill ran on the card: 100 x (1 - their union / the window)."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy() / t.window_s)
