"""Seconds an ADR iteration spends collecting: the harness's span around
each ``collect_trajectories`` call (the evaluation with its frames, the
training rounds and the surrogate-real rounds)."""
from benchkit.readers import span_mean


def read(run):
    return span_mean(run, "collect", "adr")
