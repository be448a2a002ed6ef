"""Multi-GPU scaling: env-sharded data parallelism over torch.distributed
ranks (port of ``bayes_sim_ig_tpu/parallel``).

  * each rank steps its slice of the env axis on its own device;
  * per-env random draws keep the single-device streams (``env_draw``);
  * rollouts and collected trajectories are all-gathered, and the PPO
    update, the MDN fit and the posterior run replicated on the global
    batch: bit for bit one process on the CPU, and one card on cards but
    for the rounding of the policy's GEMMs at fewer rows;
  * multi-node runs join through ``torchrun``'s environment
    (``initialize_distributed``): NCCL between cards, gloo on the CPU.
"""

from .mesh import (
    Mesh, auto_mesh, env_draw, env_slice, gather_envs, get_global_mesh,
    global_num_envs, initialize_distributed, is_main_process, local_device,
    set_global_mesh, sync_host_rng,
)

__all__ = ["Mesh", "auto_mesh", "env_draw", "env_slice", "gather_envs",
           "get_global_mesh", "global_num_envs", "initialize_distributed",
           "is_main_process", "local_device", "set_global_mesh",
           "sync_host_rng"]
