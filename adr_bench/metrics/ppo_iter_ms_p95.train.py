"""The 95th percentile of a PPO iteration's milliseconds in the window,
from ``PPO.run``'s own timing (``env_steps_per_sec``, written every
iteration to the harness's in-memory writer)."""
from benchkit.readers import percentile


def read(run):
    if run.loop != "ppo" or not run.ppo_iter_s:
        return None
    return 1e3 * percentile(run.ppo_iter_s, 95.0)
