"""Optimizers of the training path: SGD, AdamW, ProxSGD (paper eq. (7))."""
