"""Plain PyTorch oracles for the kernels (the correctness ground truth).

Written independently of the kernels' plain versions: factors are densified
and multiplied, the segment sum is a one-hot product, the group prox takes
its norms with ``torch.linalg.vector_norm``."""
from __future__ import annotations

import torch

__all__ = ["lcc_factor_dense_ref", "lcc_factor_matmul_ref",
           "lcc_chain_apply_ref", "cluster_segment_sum_ref", "group_prox_ref"]


def lcc_factor_dense_ref(idx, exp, sign, in_dim: int) -> torch.Tensor:
    """Densify a compact LCC factor: F[n, k] = sum_s sign*2^exp [idx==k]."""
    n, s = idx.shape
    val = sign.to(torch.float32) * torch.exp2(exp.to(torch.float32))
    f = torch.zeros((n, in_dim), dtype=torch.float32, device=idx.device)
    rows = torch.arange(n, device=idx.device)[:, None].expand(n, s)
    return f.index_put_((rows, idx.long()), val, accumulate=True)


def lcc_factor_matmul_ref(idx, exp, sign, x) -> torch.Tensor:
    """y = F @ x via explicit densification."""
    f = lcc_factor_dense_ref(idx, exp, sign, x.shape[0])
    return f @ x.to(torch.float32)


def lcc_chain_apply_ref(factors, x) -> torch.Tensor:
    """Apply a whole chain [(idx, exp, sign), ...] first-to-last."""
    for idx, exp, sign in factors:
        x = lcc_factor_matmul_ref(idx, exp, sign, x)
    return x


def cluster_segment_sum_ref(labels, x, num_clusters: int) -> torch.Tensor:
    """agg[C, B] = one_hot(labels)^T @ x."""
    onehot = torch.nn.functional.one_hot(labels.long(), num_clusters)
    return onehot.to(torch.float32).T @ x.to(torch.float32)


def group_prox_ref(a, thresh) -> torch.Tensor:
    """Row block soft threshold (oracle for group_prox): the float32 norm of
    each row, the scale ``max(1 - t / norm, 0)`` (0 for a zero row), the
    product in float32, one cast back to ``a``'s dtype."""
    a32 = a.to(torch.float32)
    norm = torch.linalg.vector_norm(a32, dim=1, keepdim=True)
    t = torch.as_tensor(thresh, dtype=torch.float32, device=a.device)
    scale = (1.0 - t / norm.clamp(min=1e-12)).clamp(min=0.0)
    return torch.where(norm > 0, scale * a32, 0.0).to(a.dtype)
