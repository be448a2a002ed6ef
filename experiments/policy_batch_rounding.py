"""Does the policy give a row the same bits at 512 rows as at 4 x 128?

    python experiments/policy_batch_rounding.py            # the card
    python experiments/policy_batch_rounding.py --device cpu

Builds the PPO actor-critic of ``cfg/train/ppo_cartpole.yaml`` (Cartpole's
4 observations and 1 action, the init of seed 0, as ``PPO.reinit`` draws
it) and feeds it 512 observations made from a seed: once as one batch, as
one card of a one-card run sees them, and once as four slices of 128, as
each of 4 ranks sees its envs. Prints, for ``policy_mean``, ``value`` and
each layer of the actor fed the same input both ways, the largest
difference and how many rows differ at all; a second full-batch call shows
whether a call repeats itself. Writes the summary to
chiprun_out/policy_batch_rounding.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _compare(full, sliced):
    diff = (full - sliced).abs().reshape(full.shape[0], -1)
    return {"max_abs": float(diff.max()),
            "rows_differing": int((diff.max(dim=1).values > 0).sum()),
            "rows": int(full.shape[0])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    import yaml
    from bayes_sim_ig_tpu_torch.rl import networks
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    with open(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg", "train",
                           "ppo_cartpole.yaml")) as f:
        pol = yaml.safe_load(f)["policy"]
    net = networks.ActorCritic(
        torch.Generator().manual_seed(0 + 12345), 4, 1,
        pol["pi_hid_sizes"], pol["vf_hid_sizes"],
        pol["init_noise_std"], activation=pol["activation"]).to(device)
    obs = torch.from_numpy(np.random.RandomState(0).normal(
        0.0, 1.0, (args.rows, 4)).astype(np.float32)).to(device)
    parts = obs.chunk(args.ranks)
    act = networks._ACTIVATIONS[net.activation]
    out = {"device": (torch.cuda.get_device_name(0)
                      if device.type == "cuda" else "cpu"),
           "torch": torch.__version__,
           "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
           "rows": args.rows, "ranks": args.ranks}
    with torch.no_grad():
        for name, fn in (("policy_mean", networks.policy_mean),
                         ("value", networks.value)):
            full = fn(net, obs)
            out[name] = _compare(full, torch.cat([fn(net, p)
                                                  for p in parts]))
            out[name]["repeat_max_abs"] = float(
                (fn(net, obs) - full).abs().max())
        x = obs
        for i, layer in enumerate(net.actor):
            full = layer(x)
            out[f"actor_layer_{i}"] = dict(
                _compare(full, torch.cat([layer(p)
                                          for p in x.chunk(args.ranks)])),
                in_features=layer.in_features,
                out_features=layer.out_features)
            x = act(full) if i < len(net.actor) - 1 else full
    print(json.dumps(out))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"policy_batch_rounding_{args.device}.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
