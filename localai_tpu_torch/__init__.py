"""PyTorch / CUDA port of localai_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one: the same model, engine and sampling
code in PyTorch, with every TPU (Pallas) kernel on the serving path
rewritten by hand for the H100 (`csrc/`). It imports torch, numpy and the
standard library only — never jax, never localai_tpu.
"""
