"""The dataset CLIs of the root `datasets/` directory, ported."""
