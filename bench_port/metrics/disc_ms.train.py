"""Device ms a step of the discriminator, R1 and their backward: the
replayed kernels that align with an eager step's ``disc`` stage (the
program's ``apply_discriminator`` and its backward) or its
``step/disc_forward`` and ``step/disc_backward`` ranges (lib/trace.py)."""

NEEDS = ("stages",)
STAGES = {"disc", "step/disc_forward", "step/disc_backward"}


def read(run):
    t = run.trace
    if t is None or not any(st for _, _, _, st in t.kernels):
        return None
    ms = sum(e - s for _, s, e, st in t.kernels if st in STAGES) / 1e6
    return ms / t.units if ms > 0 else None
