"""Seconds an ADR iteration spends in RL: the harness's span around
``PPO.reinit`` and ``PPO.run`` (a synchronize on each side)."""
from benchkit.readers import span_mean


def read(run):
    return span_mean(run, "ppo_run", "adr")
