"""Training: the train step and the compression-aware group regularization."""
