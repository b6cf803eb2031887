"""Package setup (parity role: reference setup.py:3-12).

Core deps are the JAX stack only; torch/transformers are optional input-side
integrations. The native runtime extension (C++ shared-memory object store)
is built separately via `make -C ray_lightning_tpu/runtime/native` and is
optional at runtime (pure-Python fallback). The PyTorch/CUDA port
(`ray_lightning_tpu_torch`) needs torch; its CUDA kernels are built with
nvcc on the machine with the card, at first use.
"""
from setuptools import find_packages, setup

setup(
    name="ray-lightning-tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed training framework: PyTorch-Lightning-style "
        "Trainer/strategies over JAX/XLA with a Ray-style actor runtime"
    ),
    packages=find_packages(include=[
        "ray_lightning_tpu", "ray_lightning_tpu.*",
        "ray_lightning_tpu_torch", "ray_lightning_tpu_torch.*",
    ]),
    # the port's CUDA sources are compiled at first use, so they ship as data
    package_data={"ray_lightning_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "test": ["pytest"],
        "torch": ["torch"],
    },
)
