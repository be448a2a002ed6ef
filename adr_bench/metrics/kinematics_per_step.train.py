"""Forward-kinematics calls an env step, read from the port's own counters
over every call of the run, the set-up's PPO iterations and the window's
alike: ``forward_kinematics`` calls, the kernel's or the chain's
(``physics/dynamics.py::STATS["kinematics"]``: one a physics substep,
and one more wherever a task's observation or reward runs it), over
``env_step`` calls (``sim/task.py::STATS``), a CUDA graph's replays
adding what its capture counted. A reset's observation adds its own
calls, with no env step. None where the port has no such counter or
stepped no env."""


def read(run):
    if run.loop != "ppo":
        return None
    try:
        from bayes_sim_ig_tpu_torch.physics.dynamics import STATS as work
        from bayes_sim_ig_tpu_torch.sim.task import STATS as steps
    except ImportError:
        return None
    if "kinematics" not in work or not steps.get("env_steps"):
        return None
    return work["kinematics"] / steps["env_steps"]
