"""PPO's training throughput: every rollout env step of the window (envs
x nsteps x PPO iterations) over all its seconds (host clock)."""


def read(run):
    if run.loop != "ppo" or not run.window_s > 0:
        return None
    return run.env_steps / run.window_s
