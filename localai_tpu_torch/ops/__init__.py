"""Compute ops: norms, rotary embeddings, attention, sampling.

Plain PyTorch on tensors of the JAX package's layouts; the prefill flash
attention launches a hand-written CUDA kernel on the card (ops/flash.py).
"""
