"""Command-line entry points of the PyTorch port (counterparts of `sgpt_tpu/cli/`)."""
