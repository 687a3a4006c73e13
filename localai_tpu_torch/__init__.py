"""PyTorch / CUDA port of localai_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one: the same model, engine and sampling
code in PyTorch, with every TPU (Pallas) kernel on the serving path
rewritten by hand for the H100 (`csrc/`), and an OpenAI-compatible HTTP
server over it (`python -m localai_tpu_torch run`). It imports torch, numpy,
the standard library and, for the server's configs and templates, yaml and
jinja2 — never jax, never localai_tpu.
"""

__version__ = "0.1.0"
