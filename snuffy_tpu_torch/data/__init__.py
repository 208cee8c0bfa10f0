"""Bag bucketing and per-bag preprocessing."""
