"""train_rays_per_s: the rays of every step the window's dispatches ran,
over the window's seconds (host clock, closed by a device sync)."""


def read(run):
    w = run.window
    return w["rays"] / w["seconds"] if "rays" in w else None
