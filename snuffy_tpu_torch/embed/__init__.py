"""Embedder registry."""
