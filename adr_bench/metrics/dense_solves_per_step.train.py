"""Mass-matrix solves on the dense route (the SPD factor and substitute)
an env step, read from the port's own counters over every call of the
run, the set-up's PPO iterations and the window's alike: dense factors
and substitutes (``physics/dynamics.py::STATS``) over ``env_step`` calls
(``sim/task.py::STATS``), a CUDA graph's replays adding what its capture
counted. None where the port has no such counter or stepped no env."""


def read(run):
    if run.loop != "ppo":
        return None
    try:
        from bayes_sim_ig_tpu_torch.physics.dynamics import STATS as solves
        from bayes_sim_ig_tpu_torch.sim.task import STATS as steps
    except ImportError:
        return None
    if not steps.get("env_steps"):
        return None
    return ((solves.get("dense_factor", 0)
             + solves.get("dense_substitute", 0)) / steps["env_steps"])
