"""Profiling entry points of the port (python -m regenie_tpu_torch.scripts.<name>)."""
