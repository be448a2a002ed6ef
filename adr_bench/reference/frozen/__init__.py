"""A frozen copy of the port's eager code that the benchmark's check runs
as its reference: the env step of ShadowHand and Humanoid with the whole
physics under it, the actor-critic networks, the MDN's net, loss and Adam
step, the summarizers and the sampling distributions, as they stood at
commit 57f9c0d of ``bayes_sim_ig_tpu_torch``.

It imports nothing of the port, and later changes to the port do not
reach it: a change that alters what the port computes shows as a gap
against this copy. What differs from the port:

  * ``ops/``: only the plain solves. ``tree_factor``, ``tree_substitute``,
    ``tree_upsolve``, ``tree_downsolve`` and the SPD factor and
    substitute run their plain PyTorch versions on every device, where
    the port launches its CUDA kernels on the card;
  * ``sim/task.py`` keeps the task functions (``env_full_reset``,
    ``env_step``) and drops the programs and ``VecEnv``; ``sim/`` holds
    the cells' tasks, which ``make_task`` finds by name;
  * ``models/mdnn.py`` keeps the net, ``mdn_loss``, ``adam_step`` and
    ``mdn_train_step`` and drops the graphed fit and ``MDNN``;
  * ``physics/dynamics.py`` reads no environment variable;
  * ``utils/device.py`` holds ``env_draw`` for one device (the port's
    ``parallel/mesh.py`` without a mesh); the tasks draw no frames, and
    ``distributions/`` keeps only the device samplers.

The SPD solves stay: ``physics/dynamics.py`` takes their route for a dof
tree that fills its mass matrix, as a later cell's task may.

Every step runs eagerly: no CUDA graph, no kernel of the port.
"""
