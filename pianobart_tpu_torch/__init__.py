"""PyTorch / CUDA port of pianobart_tpu for one NVIDIA H100.

The JAX package ``pianobart_tpu`` is the reference; this package imports
nothing from it (nor ``jax``).  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
