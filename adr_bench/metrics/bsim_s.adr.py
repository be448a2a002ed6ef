"""Seconds an ADR iteration spends in BayesSim: the harness's span around
``BayesSim.run_training`` (each chunk's summaries and fit) and
``BayesSim.predict`` (the posterior and its refit)."""
from benchkit.readers import span_mean


def read(run):
    return span_mean(run, "bsim", "adr")
