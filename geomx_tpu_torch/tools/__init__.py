"""Command-line tools of the port (``python -m geomx_tpu_torch.tools.<name>``)."""
