"""Percent of the traced slice in which no device operation ran (the
union of the profiler's kernel, copy and set intervals). The slice runs
from the evaluation's frames to the end of the first training chunk's MDN
fit: frames, one training round's step replays and extraction, and a
fit."""
from benchkit.readers import device_share


def read(run):
    return device_share(run, "adr")
