"""Classic MIL benchmark dataset CLIs."""
