"""Camelyon16 dataset CLIs."""
