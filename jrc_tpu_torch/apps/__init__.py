"""Command-line applications of the port (``python -m jrc_tpu_torch.apps.<name>``)."""
