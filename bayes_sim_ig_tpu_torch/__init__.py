"""BayesSimIG in PyTorch and CUDA: the port of ``bayes_sim_ig_tpu`` to one
NVIDIA H100.

The module layout mirrors the JAX package, so each ported function sits at
the same relative path. Tensors live on an explicit ``torch.device`` and
random draws come from explicit ``torch.Generator``s. The TPU kernels of
the JAX package are hand-written CUDA kernels here (``csrc/``, bound in
``ops/``).
"""

__version__ = "0.1.0"
