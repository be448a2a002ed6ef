"""Percent of the card's peak that the window's network FLOPs make: the
policy and value nets in rollouts, collection and PPO's updates, the MDN
in its fits, refit and predictions, counted from shapes
(``benchkit/counts.py``), over the window's seconds. The physics is not
counted."""
from benchkit.readers import mfu


def read(run):
    return mfu(run, "adr")
