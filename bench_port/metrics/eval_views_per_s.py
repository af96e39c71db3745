"""eval_views_per_s: the frames of every whole evaluate_full sweep of the
window, over the window's seconds (host clock, after the last PNG write
has returned)."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if "frames" in w else None
