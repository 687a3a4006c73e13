"""Deterministic test instrumentation (fault injection — see faults.py).

Nothing in here may import torch or any other heavy dependency: the hooks
sit on serving hot paths and must cost one attribute load when disabled.
"""
