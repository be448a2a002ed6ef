"""Build script for bayes_sim_ig_tpu's native components.

python setup.py build_ext --inplace
builds the C Halton generator (ops/native/halton.c); the package falls
back to the pure-numpy implementation when the extension is absent. The
PyTorch port (bayes_sim_ig_tpu_torch) compiles its CUDA kernels with nvcc
at first use, not here.
"""

from setuptools import Extension, setup

setup(
    name="bayes_sim_ig_tpu",
    version="0.1.0",
    packages=["bayes_sim_ig_tpu", "bayes_sim_ig_tpu_torch"],
    package_data={"bayes_sim_ig_tpu_torch": ["cfg/*.yaml", "cfg/train/*.yaml",
                                             "csrc/*.cu"]},
    ext_modules=[
        Extension(
            "bayes_sim_ig_tpu.ops.native._halton_native",
            sources=["bayes_sim_ig_tpu/ops/native/halton.c"],
            extra_compile_args=["-O3"],
        ),
        Extension(
            "bayes_sim_ig_tpu_torch.ops.native._halton_native",
            sources=["bayes_sim_ig_tpu_torch/ops/native/halton.c"],
            extra_compile_args=["-O3"],
        ),
    ],
)
