"""Model code of the served families: plain functions on tensors, parameters
as nested dicts of tensors (the JAX package's pytree, leaf for leaf)."""
