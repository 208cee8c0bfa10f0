"""TCGA lung dataset CLIs."""
