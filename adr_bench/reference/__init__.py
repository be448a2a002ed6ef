"""The plain reference the benchmark's check holds the port to: plain
PyTorch, eager, float32 with TF32 off, importing nothing of the port
(``frozen/`` is a frozen copy of its eager code with the plain solves).

  * ``step_ref``: one rollout step (the policy's draw, log-probability and
    value, then ``env_step``) from a state and generators;
  * ``train_ref``: one PPO update, one MDN fit and the posterior's
    mixtures, from weights, optimizer state, data and generators.

Each takes ``fault`` to plant one of the faults the check must catch, for
the readings that set its limits (``adr_bench/control.py``).
"""
