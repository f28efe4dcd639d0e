"""Command-line entry points of the port (`python -m image_matching_tpu_torch.cli.<name>`)."""
