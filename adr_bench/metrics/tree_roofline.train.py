"""Percent of their roofline the tree L^T D L kernels reach in the traced
slice: the least time the slice's env steps' solves could take (two
factors and two substitutes a Humanoid step, per the configuration) over
the device time of every kernel named ``tree_*kernel``."""
from benchkit.readers import tree_roofline

KERNELS = r"tree_\w*kernel"


def read(run):
    return tree_roofline(run, "ppo", KERNELS)
