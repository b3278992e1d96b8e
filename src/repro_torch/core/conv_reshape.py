"""Conv -> CMVM reshaping: FK and PK methods (paper Sec. III-D).

Kernel layout [N, K, O, O] (out-channels, in-channels, kh, kw), inputs
[B, K, Z, Z] (NCHW).  Both methods view the conv as K per-input-channel
constant matrices, which is what LCC decomposes and what the group-lasso
groups (eq. (11)) are defined over.

* FK (full kernel):    W_k in R^{N x O^2},  rows = flattened kernels.
* PK (partial kernel): W_k in R^{NO x O},   rows = single kernel *columns*
  (footnote 4: columns are used for the numerics), row order (n, j) -> n*O+j.
  Taller matrices => better LCC. Column-products are shared across the O
  horizontal output positions that see the same input column; the O partial
  outputs per conv are summed afterwards.

Addition accounting is per output spatial position (the ratio in the paper is
invariant to the position count since baseline and compressed counts both
scale by it):

  FK:  sum_k adds(W_k) + N*(K_nz - 1)
  PK:  sum_k adds(W_k) + N*(O - 1) + N*(K_nz - 1)   [amortized: one new
       column-matvec per output position; O-1 partial combines per output]

The reshapes and the accounting are numpy, as in the reference
(``repro.core.conv_reshape``), and give bitwise its matrices; the forwards
and window extractions take torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "conv_fk_matrices",
    "conv_pk_matrices",
    "fk_group_matrix",
    "pk_group_matrix",
    "conv_forward_reference",
    "conv_forward_fk",
    "conv_forward_pk",
    "conv_layer_adds",
    "same_pad_2d",
    "extract_patches",
    "extract_vert_windows",
]


def conv_fk_matrices(kernel: np.ndarray) -> np.ndarray:
    """[N, K, O, O] -> [K, N, O*O]."""
    n, k, o1, o2 = kernel.shape
    return np.transpose(kernel, (1, 0, 2, 3)).reshape(k, n, o1 * o2)


def conv_pk_matrices(kernel: np.ndarray) -> np.ndarray:
    """[N, K, O, O] -> [K, N*O, O]; row (n, j) = kernel[n, k, :, j] (a column)."""
    n, k, oh, ow = kernel.shape
    # [K, N, ow(j), oh(i)]: row block per n is its ow columns, each of length oh
    m = np.transpose(kernel, (1, 0, 3, 2))
    return m.reshape(k, n * ow, oh)


def fk_group_matrix(kernel: np.ndarray) -> np.ndarray:
    """Eq. (11): stack the FK matrices -> groups are rows (= whole kernels)."""
    mats = conv_fk_matrices(kernel)  # [K, N, O^2]
    return mats.reshape(-1, mats.shape[-1])


def pk_group_matrix(kernel: np.ndarray) -> np.ndarray:
    """Eq. (11) for PK: groups are single kernel columns."""
    mats = conv_pk_matrices(kernel)  # [K, N*O, O]
    return mats.reshape(-1, mats.shape[-1])


def conv_forward_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain VALID / stride-1 conv (cross-correlation), NCHW/OIHW."""
    return F.conv2d(x, kernel.to(x.dtype))


def conv_forward_fk(x: torch.Tensor, fk_mats: torch.Tensor) -> torch.Tensor:
    """Conv evaluated through the FK matrices. fk_mats: [K, N, O^2]."""
    k, n, oo = fk_mats.shape
    o = int(round(np.sqrt(oo)))
    b, kk, z, _ = x.shape
    if kk != k:
        raise ValueError(f"x has {kk} channels, the FK matrices {k}")
    p = z - o + 1
    # im2col per channel: [B, K, P, P, O, O]
    patches = extract_patches(x, o)
    # y[b, n, p, q] = sum_k fk[k, n, :] . patch[b, k, p, q, :]
    return torch.einsum("kno,bkpqo->bnpq", fk_mats.to(x.dtype),
                        patches.reshape(b, k, p, p, oo))


def conv_forward_pk(x: torch.Tensor, pk_mats: torch.Tensor, n_out: int) -> torch.Tensor:
    """Conv evaluated through the PK matrices. pk_mats: [K, N*O, O].

    partial[b,k,p,cq,(n,j)] = pk[k,(n,j),:] . x[b,k,p:p+O,cq]  (a column product)
    y[b,n,p,q] = sum_k sum_j partial at column cq = q + j.
    """
    k, no, o = pk_mats.shape
    n = n_out
    if no != n * o:
        raise ValueError(f"PK matrices have {no} rows, expected {n} * {o}")
    b, kk, z, _ = x.shape
    p = z - o + 1
    # column windows: [B, K, P, Z, O] — vertical O-slices at every (row p, col c)
    cols = extract_vert_windows(x, o)  # [B, K, P, Z, O]
    part = torch.einsum("kro,bkpco->bkpcr", pk_mats.to(x.dtype), cols)  # r = (n, j)
    part = part.reshape(b, k, p, z, n, o)
    # gather j-offset columns: y[..., q] = sum_j part[..., q + j, :, j]
    qs = torch.arange(p, device=x.device)
    js = torch.arange(o, device=x.device)
    cq = qs[:, None] + js[None, :]  # [P, O]
    sel = part[:, :, :, cq, :, :]  # [B, K, P, P, O(j), N, O(j')]
    # the diagonal j == j' of the two O axes, then the sum over j
    diag = torch.diagonal(sel, dim1=4, dim2=6).sum(dim=-1)  # [B, K, P, P, N]
    y = diag.sum(dim=1)  # sum over input channels
    return torch.movedim(y, -1, 1)  # [B, N, P, P]


def same_pad_2d(z: int, o: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding amounts (lo, hi) along one spatial dim."""
    out = -(-z // stride)  # ceil division
    total = max((out - 1) * stride + o - z, 0)
    return total // 2, total - total // 2


def extract_patches(x: torch.Tensor, o: int, stride: int = 1) -> torch.Tensor:
    """[B, K, Z, Z] -> [B, K, P, P, O, O] sliding windows (valid, strided)."""
    b, k, z, _ = x.shape
    p = (z - o) // stride + 1
    i = (stride * torch.arange(p, device=x.device)[:, None]
         + torch.arange(o, device=x.device)[None, :])  # [P, O]
    rows = x[:, :, i, :]  # [B, K, P, O, Z]
    cols = rows[:, :, :, :, i]  # [B, K, P, O, P, O]
    return cols.permute(0, 1, 2, 4, 3, 5)  # [B, K, P, P, O, O]


def extract_vert_windows(x: torch.Tensor, o: int, stride: int = 1) -> torch.Tensor:
    """[B, K, Z, Z] -> [B, K, P, Z, O]: vertical O-windows at each (strided
    output row p, input column)."""
    b, k, z, _ = x.shape
    p = (z - o) // stride + 1
    i = (stride * torch.arange(p, device=x.device)[:, None]
         + torch.arange(o, device=x.device)[None, :])  # [P, O]
    win = x[:, :, i, :]  # [B, K, P, O, Z]
    return win.permute(0, 1, 2, 4, 3)  # [B, K, P, Z, O]


def conv_layer_adds(per_matrix_adds: list[int], n_out: int, o: int, method: str,
                    n_channels_nonzero: int | None = None) -> int:
    """Per-output-position additions for a conv layer given per-W_k CMVM adds."""
    k_nz = n_channels_nonzero if n_channels_nonzero is not None else len(per_matrix_adds)
    total = int(sum(per_matrix_adds))
    if method == "fk":
        return total + n_out * max(0, k_nz - 1)
    if method == "pk":
        return total + n_out * (o - 1) + n_out * max(0, k_nz - 1)
    raise ValueError(f"unknown conv method {method!r}")
