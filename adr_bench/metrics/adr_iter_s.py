"""Seconds per ADR iteration: the window's wall time over the whole ADR
iterations it ran (host clock, a synchronize at each end)."""


def read(run):
    if run.loop != "adr" or run.units <= 0:
        return None
    return run.window_s / run.units
