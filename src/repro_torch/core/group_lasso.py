"""Group-lasso regularization via proximal gradients (paper Sec. III-B).

Counterpart of ``repro.core.group_lasso``.  The regularizer (eq. (6))
penalizes the l2 norms of *groups* (rows of a reshaped weight matrix), and
training interleaves SGD steps with the proximal operator (eq. (7)), which is
row-wise block soft thresholding (eq. (8)):

    prox(A)_i = max(1 - eta*lambda / ||A_i||_2, 0) * A_i

Dense layers: groups = columns of W (input neurons), i.e. rows of W^T.

Both numpy (offline) and torch (in training; the fused CUDA kernel is
``repro_torch.kernels.group_prox``) versions live here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "group_prox_rows_np",
    "group_prox_rows",
    "group_lasso_penalty",
    "prox_dense_columns",
    "prox_dense_columns_np",
    "group_norms",
]

_EPS = 1e-12


def group_prox_rows_np(a: np.ndarray, thresh: float) -> np.ndarray:
    """Block soft threshold on rows (eq. (8)), numpy, in float64.

    ``||A_i|| = 0`` rows map to exactly 0: the prox of the zero group is the
    zero group for any threshold, and guarding explicitly (instead of an eps
    in the divisor) keeps the output free of NaN/Inf.
    """
    a = np.asarray(a, dtype=np.float64)
    norms = np.linalg.norm(a, axis=-1, keepdims=True)
    scale = np.where(norms > 0.0,
                     np.maximum(1.0 - thresh / np.maximum(norms, _EPS), 0.0),
                     0.0)
    return scale * a


def group_prox_rows(a: torch.Tensor, thresh) -> torch.Tensor:
    """Block soft threshold on rows (eq. (8)), torch, in ``a``'s dtype (as the
    reference's jnp version computes in its input's dtype).  Groups are the
    last axis; zero-norm rows map to exactly 0."""
    norms = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    scale = torch.where(
        norms > 0.0,
        torch.clamp(1.0 - thresh / torch.clamp(norms, min=_EPS), min=0.0),
        torch.zeros_like(norms))
    return scale * a


def prox_dense_columns(w: torch.Tensor, thresh) -> torch.Tensor:
    """Dense-layer prox: groups are *columns* (input neurons), i.e. rows of W^T."""
    return group_prox_rows(w.T, thresh).T


def prox_dense_columns_np(w: np.ndarray, thresh: float) -> np.ndarray:
    return group_prox_rows_np(np.asarray(w).T, thresh).T


def group_norms(w, axis: int = 0):
    """l2 norm per group where ``axis`` indexes *within* the group."""
    if isinstance(w, np.ndarray):
        return np.linalg.norm(w, axis=axis)
    return torch.sqrt(torch.sum(w * w, dim=axis))


def group_lasso_penalty(w, lam: float, groups_axis: int = 0):
    """R = lambda * sum_groups ||group||_2  (eq. (6)), for logging/objective."""
    return lam * group_norms(w, axis=groups_axis).sum()
