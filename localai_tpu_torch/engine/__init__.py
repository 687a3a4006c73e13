"""Serving engine (PyTorch): the resident engine, weights and tokenizers.

Import the modules directly (`localai_tpu_torch.engine.engine`,
`.weights`, `.tokenizer`, `.runtime`).
"""
