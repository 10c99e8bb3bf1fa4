"""Command-line entry points of the port (`python -m paroquant_tpu_torch.cli.<name>`)."""
