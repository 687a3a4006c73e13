"""Host utilities of the port (localai_tpu/utils)."""
