"""PyTorch/CUDA port of ray_lightning_tpu for one NVIDIA H100.

This package imports torch and numpy, never JAX and nothing of
``ray_lightning_tpu``. It holds the Llama family (dense and mixture of
experts, importable from Hugging Face checkpoints through
``models.hf_import``), its generation (``models.generation.generate``
on the rolling-window cache), its serving engine on the slot and paged KV
layouts (prefill with flash attention, dense or paged decode and the
argmax sampler) and the single-device training step of the dense family
(``core.Trainer.fit`` on ``models.llama.LlamaModule``: forward, backward through the flash-attention
backward kernels, AdamW). Each kernel is hand-written in CUDA C++ for
``sm_90a`` (``csrc/``) beside its plain PyTorch version. Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
