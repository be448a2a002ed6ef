"""Pair-contact evaluations an env step, read from the port's own counters
over every call of the run, the set-up's PPO iterations and the window's
alike: the calls of the pair-contact functions of every kind
(``physics/contact.py::STATS``; FrankaCabinet's two finger pads against
the drawer handle, each substep) over ``env_step`` calls
(``sim/task.py::STATS``), a CUDA graph's replays adding what its capture
counted. None where the port has no such counter or stepped no env."""


def read(run):
    if run.loop != "ppo":
        return None
    try:
        from bayes_sim_ig_tpu_torch.physics.contact import STATS as pairs
        from bayes_sim_ig_tpu_torch.sim.task import STATS as steps
    except ImportError:
        return None
    if not steps.get("env_steps"):
        return None
    return sum(pairs.values()) / steps["env_steps"]
