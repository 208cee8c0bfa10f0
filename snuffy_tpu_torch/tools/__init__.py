"""Measurement tools for the port, run as `python -m snuffy_tpu_torch.tools.<name>`."""
