"""Self-supervised pretraining of the embedders (DINO-adapter)."""
