# Frozen copy of bayes_sim_ig_tpu_torch/utils/__init__.py (commit 57f9c0d); see frozen/__init__.py for what changed.
