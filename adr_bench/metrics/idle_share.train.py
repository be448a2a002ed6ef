"""Percent of the traced slice in which no device operation ran (the
union of the profiler's kernel, copy and set intervals). The slice is two
whole PPO iterations inside the window."""
from benchkit.readers import device_share


def read(run):
    return device_share(run, "ppo")
