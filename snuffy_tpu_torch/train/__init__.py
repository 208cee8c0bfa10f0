"""MIL training: losses, the trainer, the epoch runner and the CLI
(`python -m snuffy_tpu_torch.train`)."""
