"""Compute ops: norms, rotary embeddings, attention, sampling, quantized
matmuls.

Plain PyTorch on tensors of the JAX package's layouts; the prefill flash
attention (ops/flash.py), the paged attention partials (ops/paged_flash.py)
and the quantized matmuls (ops/quant_matmul.py) launch hand-written CUDA
kernels on the card.
"""
