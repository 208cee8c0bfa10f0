"""MIL losses and the packed bag-classification eval."""
