"""Weight-sharing input pre-aggregation (paper eq. (10)) on the GPU.

Counterpart of ``repro.kernels.shared_matmul`` (Pallas TPU):
``agg[c, b] = sum_{j: labels[j]==c} x[j, b]`` — the per-cluster sums that let
the centroid matrix replace the full weight matrix.  The TPU kernel builds a
one-hot tile and contracts on the matrix unit; here the labels are sorted
once (:func:`csr_from_labels`, at site build time) and each output element
walks its segment in fixed order — no float atomics, so the result does not
depend on scheduling and equals the plain version bit for bit.  CUDA source:
``csrc/cluster_segment_sum.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build, dispatch

__all__ = ["cluster_segment_sum", "cluster_segment_sum_plain",
           "csr_from_labels"]


def csr_from_labels(labels, num_clusters: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort labels once: ``order [K]`` lists input rows cluster by cluster
    (ascending row inside a cluster), ``offsets [C + 1]`` bounds each cluster."""
    lab = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels,
                     dtype=np.int64)
    if lab.size and (lab.min() < 0 or lab.max() >= num_clusters):
        raise ValueError(f"labels outside [0, {num_clusters})")
    order = np.argsort(lab, kind="stable").astype(np.int32)
    offsets = np.zeros(num_clusters + 1, np.int32)
    np.cumsum(np.bincount(lab, minlength=num_clusters), out=offsets[1:])
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(offsets).to(device))


def cluster_segment_sum_plain(labels: torch.Tensor, x: torch.Tensor,
                              num_clusters: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of x's rows into their clusters."""
    out = torch.zeros((num_clusters, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, labels.long(), x.to(torch.float32))


def cluster_segment_sum(labels: torch.Tensor, x: torch.Tensor,
                        num_clusters: int, *, csr=None) -> torch.Tensor:
    """agg[C, B] = segment_sum(x[K, B], labels[K]).

    CUDA tensors launch the kernel (or raise) and need ``csr``, the site's
    ``csr_from_labels(labels, num_clusters, x.device)`` built once when the
    site is set up; CPU tensors take :func:`cluster_segment_sum_plain`, which
    needs none."""
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"expected x [K, B] and labels [K], got "
                         f"{tuple(x.shape)} and {tuple(labels.shape)}")
    if not dispatch.on_device(x):
        return cluster_segment_sum_plain(labels, x, num_clusters)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("cluster_segment_sum kernel takes contiguous float32 x, "
                        f"got {x.dtype}, contiguous={x.is_contiguous()}")
    if csr is None:
        raise ValueError("cluster_segment_sum on a CUDA tensor needs csr= "
                         "(csr_from_labels, built once per site)")
    order, offsets = csr
    k, b = x.shape
    for nm, t, shape in (("order", order, (k,)),
                         ("offsets", offsets, (num_clusters + 1,))):
        if (t.device != x.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"csr {nm} must be contiguous int32 {shape} on "
                             f"{x.device}")
    if num_clusters <= 0 or b <= 0:
        raise ValueError(f"empty launch: C={num_clusters}, B={b}")
    lib = build.load()
    out = torch.empty((num_clusters, b), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.repro_cluster_segment_sum(
            order.data_ptr(), offsets.data_ptr(), x.data_ptr(), out.data_ptr(),
            num_clusters, b, torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_cluster_segment_sum")
    dispatch.record_launch("cluster_segment_sum", shape=(k, num_clusters, b))
    return out
