"""The Llama family, its converter from the JAX package, and generation."""
