"""Percent of the env steps collection steps whose episodes it keeps:
``collect_trajectories`` steps every env of every round (rounds x envs x
steps) and returns ``num_trajs`` episodes (num_trajs x steps). Read from
the port's own counter (``utils/collect.py::STATS``) over every call of
the run: the set-up's ADR iterations and the window's collect alike, so
the share is each iteration's. None where the port has no such counter
or collected nothing."""


def read(run):
    if run.loop != "adr":
        return None
    try:
        from bayes_sim_ig_tpu_torch.utils.collect import STATS
    except ImportError:
        return None
    if not STATS.get("stepped"):
        return None
    return 100.0 * STATS["kept"] / STATS["stepped"]
