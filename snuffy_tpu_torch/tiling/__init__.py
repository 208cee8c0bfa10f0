"""Slide tiling: read-level choice and the background filter."""
