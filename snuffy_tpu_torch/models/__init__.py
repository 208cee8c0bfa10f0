"""MILNet aggregator and DINO ViT embedder."""
