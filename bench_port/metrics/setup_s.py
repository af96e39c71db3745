"""setup_s: process start to the window's start (host clock): data, engine,
weights, kernel builds, the compared first steps or frames, warm-up."""


def read(run):
    return run.setup_s
