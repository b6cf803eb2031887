"""Ops of the port: each module holds a hand-written CUDA kernel beside its
plain PyTorch version."""
