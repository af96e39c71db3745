"""Share of the traced window with no kernel, copy or fill on the card:
1 − (union of the device intervals) / (the window's host span), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
