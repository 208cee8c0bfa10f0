"""Tiles to slide scores."""
