"""Env-sharded data parallelism over ``torch.distributed`` ranks.

Port of ``bayes_sim_ig_tpu/parallel/mesh.py``. The JAX package runs one
process and lets GSPMD shard the env axis of its jitted programs over a
device mesh. Here each rank is one process on one device
(``cuda:LOCAL_RANK``, NCCL; or the CPU, gloo):

  * each rank steps only its ``numEnvs / W`` envs (PPO rollouts,
    collection rounds, the surrogate-real evaluation);
  * every per-env random draw goes through ``env_draw``: each rank draws
    the whole env axis from a generator seeded as on one device and keeps
    its slice, so the streams stay those of a single device;
  * rollouts and collected trajectories are all-gathered
    (``gather_envs``), so every rank holds the global batch in global env
    order;
  * the PPO update, the MDN fit and the posterior then run replicated on
    that batch with the same generator seeds, and numpy's global
    generator starts from rank 0's state on every rank
    (``sync_host_rng``), so the parameters stay identical on every rank
    without a broadcast.

On the CPU (gloo) a run over W ranks equals one process bit for bit. On
cards it equals one card except for the rounding of the policy's GEMMs,
which cuBLAS does differently at ``numEnvs / W`` rows than at
``numEnvs``; policy-driven rollouts amplify those last bits.

The mesh is a process-wide setting, as the JAX package's global mesh is:
``setup_parallelism`` installs it once, before any env is built, and the
env, PPO and collection code consult it.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

class Mesh(NamedTuple):
    """A 1-D env mesh over the whole default process group: ``size`` ranks
    split the env axis, and this process is ``rank`` on it."""
    size: int
    rank: int


# Set once at startup by setup_parallelism / set_global_mesh.
_GLOBAL_MESH: list = [None]


def set_global_mesh(mesh: Optional[Mesh]):
    """Installs (or clears, with None) the process-wide env mesh."""
    _GLOBAL_MESH[0] = mesh


def get_global_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH[0]


def _world() -> tuple:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_main_process() -> bool:
    """True on rank 0, or without a process group: the process that logs,
    plots and writes checkpoints."""
    return _world()[1] == 0


def local_device(device) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA run under a
    process group of more than one rank, else ``device`` itself."""
    device = torch.device(device)
    world, rank = _world()
    if device.type != "cuda" or world == 1:
        return device
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def auto_mesh(num_envs: int) -> Optional[Mesh]:
    """1-D env mesh over every rank of the default process group; None
    for a single rank. The ranks were launched to be used, so a
    ``num_envs`` they do not divide raises instead of leaving some
    idle."""
    world, rank = _world()
    if world <= 1:
        return None
    if num_envs % world != 0:
        raise ValueError(f"numEnvs={num_envs} does not split over the "
                         f"{world} ranks: pick a multiple of {world}")
    return Mesh(size=world, rank=rank)


def env_slice(num_envs: int, mesh: Optional[Mesh] = None) -> slice:
    """This rank's slice of a global env axis of ``num_envs``."""
    mesh = _GLOBAL_MESH[0] if mesh is None else mesh
    if mesh is None or mesh.size <= 1:
        return slice(0, num_envs)
    if num_envs % mesh.size != 0:
        raise ValueError(f"{num_envs} envs do not split over "
                         f"{mesh.size} ranks")
    n = num_envs // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def global_num_envs(num_local: int) -> int:
    """The env count of the whole mesh given this rank's."""
    mesh = _GLOBAL_MESH[0]
    return num_local * (1 if mesh is None else mesh.size)


def _tree_map(fn, tree):
    """Applies ``fn`` to every tensor leaf of nested tuples (named too),
    lists and dicts; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def env_draw(draw, shape, generator: torch.Generator, env_dim: int = 0,
             **kwargs) -> torch.Tensor:
    """``draw(shape, generator=generator, **kwargs)`` for a per-env draw
    whose ``env_dim`` axis holds this rank's envs. Under a global mesh of
    W ranks it draws that axis for all W * n envs and keeps this rank's
    slice: every rank's generator holds the single-device stream, so a
    sharded run draws exactly what one device would."""
    mesh = _GLOBAL_MESH[0]
    if mesh is None or mesh.size <= 1:
        return draw(tuple(shape), generator=generator, **kwargs)
    full = list(shape)
    full[env_dim] *= mesh.size
    sl = env_slice(full[env_dim], mesh)
    out = draw(tuple(full), generator=generator, **kwargs)
    return out.narrow(env_dim, sl.start, sl.stop - sl.start)


def gather_envs(tree, dim: int = 0):
    """All-gathers every tensor leaf along its env axis ``dim`` in rank
    order, so each rank holds the global batch in global env order.
    Identity without a mesh."""
    mesh = _GLOBAL_MESH[0]
    if mesh is None or mesh.size <= 1:
        return tree

    def gather(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    return _tree_map(gather, tree)


def sync_host_rng():
    """Gives every rank rank 0's state of numpy's global generator, which
    the port leaves unseeded as the JAX package does. Its draws (MDRFF's
    frequencies above 100 input dims, the refit's resampling of the
    posterior mixtures) then match on every rank, as the replicated fits
    need. No-op without a process group of more than one rank."""
    if _world()[0] <= 1:
        return
    state = [np.random.get_state()]
    dist.broadcast_object_list(state, src=0)
    np.random.set_state(state[0])


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 300.0) -> bool:
    """Joins a ``torch.distributed`` process group.

    With no arguments it joins the cluster that ``torchrun`` describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or returns
    False when those variables are not set. Explicit arguments give the
    coordinator ``host:port``, the process count and this process's rank,
    the single-process form (``num_processes=1, process_id=0``, a local
    port) included. ``backend`` defaults to NCCL with a card and gloo
    without. Returns True if the group was initialized here, False if it
    was skipped (already initialized, or no cluster to join).

    Only "already initialized" is skipped: a bring-up failure, with
    explicit arguments or with a torchrun environment, raises instead of
    falling back to a single process."""
    if not dist.is_available() or dist.is_initialized():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("initialize_distributed needs "
                             "coordinator_address, num_processes and "
                             "process_id together")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} is not in "
                             f"[0, {num_processes})")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timeout)
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT")):
        return False  # no cluster environment to join
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True
