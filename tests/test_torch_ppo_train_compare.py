"""``experiments/ppo_train_compare.py`` on the CPU at a tiny size: PPO on
ShadowHand's grasp config in both packages from one seed."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import ppo_train_compare  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ppo_trains_in_both_packages():
    """``experiments/ppo_train_compare.py`` at 4 envs, 2 PPO iterations,
    20-step episodes: both packages log every iteration's metrics and
    score the policy on whole episodes."""
    runs = ppo_train_compare.main(["--envs", "4", "--iters", "2",
                                   "--seeds", "0", "--episode_length",
                                   "20"])
    assert sorted(runs) == [("jax", 0), ("torch", 0)]
    for (pkg, _), (curves, rewards) in runs.items():
        for tag in ("rl/mean_reward", "rl/lr", "rl/approx_kl"):
            assert len(curves[tag]) == 2 and np.isfinite(curves[tag]).all()
        assert rewards.shape == (4,) and np.isfinite(rewards).all(), pkg
