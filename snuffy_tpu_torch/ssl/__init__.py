"""Self-supervised pretraining of the embedders (DINO- and MAE-adapter)."""
