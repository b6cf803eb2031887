"""PyTorch/CUDA port of ray_lightning_tpu for one NVIDIA H100.

This package imports torch and numpy, never JAX and nothing of
``ray_lightning_tpu``. Its first slice is the paged serving path of the
Llama family: prefill (flash attention), paged decode and the argmax
sampler, each kernel hand-written in CUDA C++ for ``sm_90a``
(``csrc/``) beside its plain PyTorch version. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
