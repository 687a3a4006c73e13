"""Compute ops: norms, rotary embeddings, attention, sampling, quantized
matmuls, LoRA deltas, the grammar automaton's mask and step.

Plain PyTorch on tensors of the JAX package's layouts; the prefill flash
attention (ops/flash.py), the paged attention partials (ops/paged_flash.py),
the quantized matmuls (ops/quant_matmul.py) and the per-row LoRA delta
(ops/lora_matmul.py) launch hand-written CUDA kernels on the card.
"""
