"""Percent of their roofline the SPD kernels reach in the traced slice:
the least time the slice's env steps' dense mass-matrix solves could take
(an Anymal step's two factors and two substitutes of its 18-dof matrix,
per the configuration's ``spd_solves_per_step``, are two solves;
``benchkit/spd_counts.py``) over the device time of every kernel named
``spd_*kernel``. None where the configuration has no dense solves or the
slice ran no such kernel."""
from benchkit import spd_counts

KERNELS = r"spd_\w*kernel"


def read(run):
    s = run.slice
    calls = run.config.get("spd_solves_per_step")
    if run.loop != "ppo" or s is None or s.env_steps <= 0 or not calls:
        return None
    spent = s.device_seconds(KERNELS)
    if spent <= 0.0:
        return None
    bound = s.env_steps * spd_counts.spd_step_seconds(
        int(run.task["num_envs"]), calls)
    return 100.0 * bound / spent
