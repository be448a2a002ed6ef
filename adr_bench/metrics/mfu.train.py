"""Percent of the card's peak that the window's network FLOPs make: the
policy and value nets in the rollouts and PPO's updates, counted from
shapes (``benchkit/counts.py``), over the window's seconds. The physics is
not counted."""
from benchkit.readers import mfu


def read(run):
    return mfu(run, "ppo")
