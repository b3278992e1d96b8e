"""Input preparation of the per-region route on the GPU: the prune gather and
the weight-sharing pre-aggregation (paper eq. (10)) of every member of one
fused region, in one launch.

Counterpart of ``repro.kernels.shared_matmul`` (Pallas TPU, K3):
``agg[c, b] = sum_{j: labels[j]==c} x[j, b]`` — the per-cluster sums that let
the centroid matrix replace the full weight matrix.  The TPU kernel builds a
one-hot tile and contracts on the matrix unit.  Here each member's labels are
sorted once at site build (:func:`csr_from_labels`) and composed with its
kept columns on the host (:func:`member_table`), so one output row is one
segment of source rows of the member's input: a weight-shared member's row
``c`` sums cluster ``c``'s kept columns, a member with pruning only copies
one kept column.  :class:`RegionPrep` concatenates the members' tables, so
one launch writes the whole input of one K1/K2 launch — gather, segment
sums and concatenation — and each output element walks its segment in
ascending order with no float atomics: the result does not depend on
scheduling and equals the per-member plain path (``index_select``,
:func:`cluster_segment_sum_plain`, ``torch.cat``) bit for bit.  CUDA source:
``csrc/cluster_segment_sum.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build, dispatch

__all__ = ["RegionPrep", "cluster_segment_sum", "cluster_segment_sum_plain",
           "csr_from_labels", "member_table", "region_layout",
           "region_prep_plain"]

_BF16 = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's input types


def _csr(labels, num_clusters: int) -> tuple[np.ndarray, np.ndarray]:
    lab = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels,
                     dtype=np.int64)
    if lab.size and (lab.min() < 0 or lab.max() >= num_clusters):
        raise ValueError(f"labels outside [0, {num_clusters})")
    order = np.argsort(lab, kind="stable").astype(np.int32)
    offsets = np.zeros(num_clusters + 1, np.int32)
    np.cumsum(np.bincount(lab, minlength=num_clusters), out=offsets[1:])
    return order, offsets


def csr_from_labels(labels, num_clusters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort labels once, on the host: ``order [K]`` lists input rows cluster
    by cluster (ascending row inside a cluster), ``offsets [C + 1]`` bounds
    each cluster."""
    order, offsets = _csr(labels, num_clusters)
    return torch.from_numpy(order), torch.from_numpy(offsets)


def member_table(kept, labels=None, num_clusters: int = 0
                 ) -> tuple[np.ndarray, np.ndarray]:
    """One member's composed table: output row ``r`` sums the member's input
    rows ``src[seg[r]:seg[r + 1]]`` in that (ascending) order.  Weight-shared:
    ``src = kept[order]``, ``seg = offsets`` of :func:`csr_from_labels`;
    pruning only: ``src = kept``, one row a segment."""
    kept = np.asarray(kept, np.int64)
    if labels is None:
        return kept.astype(np.int32), np.arange(kept.size + 1, dtype=np.int32)
    if np.shape(labels) != kept.shape:
        raise ValueError(f"{np.size(labels)} labels for {kept.size} kept columns")
    order, offsets = _csr(labels, num_clusters)
    return kept[order].astype(np.int32), offsets


def cluster_segment_sum_plain(labels: torch.Tensor, x: torch.Tensor,
                              num_clusters: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of x's rows into their clusters."""
    out = torch.zeros((num_clusters, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, labels.long(), x.to(torch.float32))


def region_layout(xs, n_members: int) -> tuple[list[torch.Tensor], int]:
    """``(views, member_stride)`` of a region's input: the G member inputs
    ``[K, B]`` and the element distance from one member's input to the
    next.  Takes one tensor shared by every member (stride 0), or a list of G
    views of one stacked tensor, all of one shape, strides and type, equally
    spaced (``[z[e].T for e in range(E)]`` of a ``[E, C, K]`` buffer); raises
    on any other layout."""
    if isinstance(xs, torch.Tensor):
        xs, step = [xs] * n_members, 0
    else:
        xs = list(xs)
        if len(xs) != n_members:
            raise ValueError(f"{n_members} region members, {len(xs)} inputs")
        x0 = xs[0]
        step = xs[1].storage_offset() - x0.storage_offset() if n_members > 1 else 0
        for g, x in enumerate(xs):
            if (x.shape != x0.shape or x.stride() != x0.stride()
                    or x.dtype != x0.dtype or x.device != x0.device
                    or x.untyped_storage().data_ptr()
                    != x0.untyped_storage().data_ptr()
                    or x.storage_offset() != x0.storage_offset() + g * step):
                raise ValueError(
                    "a region's inputs must be one tensor shared by every "
                    "member or equally spaced views of one stacked tensor "
                    f"(member {g} is not)")
    if xs[0].dim() != 2:
        raise ValueError(f"expected [K, B] inputs, got {tuple(xs[0].shape)}")
    return xs, step


def region_prep_plain(prep: "RegionPrep", xs) -> torch.Tensor:
    """Plain PyTorch version of :class:`RegionPrep`'s launch: per member
    ``index_select`` of the kept columns, :func:`cluster_segment_sum_plain`
    where it is weight-shared, then one ``torch.cat``."""
    views, _ = region_layout(xs, prep.n_members)
    parts = []
    for (kept, labels, c), x in zip(prep.plain_indices(views[0].device), views):
        xg = x.index_select(0, kept)
        if labels is not None:
            xg = cluster_segment_sum_plain(labels, xg.to(torch.float32), c)
        parts.append(xg.to(torch.float32).contiguous())
    return torch.cat(parts)


class RegionPrep:
    """The input preparation of one fused region (or one site): members
    ``(kept [K'], labels [K'] or None, n_clusters)``; ``name`` tells the
    region apart in the launch counts (its sites, without the layer).

    Call with the region's input (:func:`region_layout`: one shared tensor
    or views of one stacked tensor, float32 or bfloat16, any strides); returns
    the contiguous float32 ``[sum_g rows_g, B]`` input of the K1/K2 launch,
    member g at rows ``out_off[g]:out_off[g + 1]``.  A single member with an
    identity keep and no sharing hands its input back untouched (no launch).
    The composed tables go to the device at the first call."""

    def __init__(self, members, name: str = ""):
        self.name = name
        self.members = tuple(
            (np.asarray(kept, np.int64),
             None if labels is None else np.asarray(labels, np.int64), int(c))
            for kept, labels, c in members)
        if not self.members:
            raise ValueError("a region needs at least one member")
        srcs, segs, info, out_off = [], [], [], [0]
        for g, (kept, labels, c) in enumerate(self.members):
            src, seg = member_table(kept, labels, c)
            base = sum(s.size for s in srcs)
            srcs.append(src)
            segs.append(seg[:-1] + base)
            # row info: member index and whether the row is a copy (pruning
            # only: the sum starts from -0.0, so a one-row segment is exact)
            info.append(np.full(seg.size - 1, 2 * g + (labels is None), np.int32))
            out_off.append(out_off[-1] + seg.size - 1)
        self.src = np.concatenate(srcs).astype(np.int32)
        self.segptr = np.append(np.concatenate(segs),
                                np.int32(self.src.size)).astype(np.int32)
        self.rowinfo = np.concatenate(info)
        self.out_off = tuple(out_off)
        self.rows_in = int(self.src.max()) + 1 if self.src.size else 0
        kept, labels, _ = self.members[0]
        self.identity = (len(self.members) == 1 and labels is None
                         and bool((kept == np.arange(kept.size)).all()))
        self._dev: dict = {}

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def rows(self) -> int:
        """Rows of the prepared input (sum of the members' rows)."""
        return self.out_off[-1]

    def shape_key(self, k: int, b: int, itemsize: int) -> tuple:
        """The key a launch is counted under: the region's name, members,
        input rows, output rows, columns and input bytes an element."""
        return (self.name, self.n_members, k, self.rows, b, itemsize)

    def launches(self, xs) -> int:
        """Launches a call with ``xs`` makes: 0 when the input passes
        through untouched, else 1."""
        return 0 if self._passes(xs) else 1

    def _passes(self, xs) -> bool:
        x = xs if isinstance(xs, torch.Tensor) else None
        return self.identity and x is not None and x.shape[0] == self.rows

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(src, segptr, rowinfo)`` on ``device`` (uploaded once)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = tuple(dispatch.upload(a, device) for a in
                                      (self.src, self.segptr, self.rowinfo))
        return self._dev[device]

    def plain_indices(self, device) -> list:
        """The members' ``(kept, labels, n_clusters)`` as index tensors on
        ``device`` (made once), for :func:`region_prep_plain`."""
        key = (torch.device(device), "plain")
        if key not in self._dev:
            self._dev[key] = [
                (dispatch.upload(kept, device),
                 None if labels is None else dispatch.upload(labels, device),
                 c) for kept, labels, c in self.members]
        return self._dev[key]

    def __call__(self, xs) -> torch.Tensor:
        if self._passes(xs):
            return xs
        views, step = region_layout(xs, self.n_members)
        k, b = views[0].shape
        if k < self.rows_in:
            raise ValueError(f"the region reads input row {self.rows_in - 1}, "
                             f"the input has {k} rows")
        if not dispatch.on_device(views[0]):
            return region_prep_plain(self, views)
        x = views[0]
        if x.dtype not in _BF16:
            raise TypeError(f"region prep takes float32 or bfloat16, got {x.dtype}")
        if b <= 0 or self.rows <= 0:
            raise ValueError(f"empty launch: rows={self.rows}, B={b}")
        src, segptr, rowinfo = self.on(x.device)
        out = torch.empty((self.rows, b), dtype=torch.float32, device=x.device)
        _launch(src, segptr, rowinfo, x, out, step)
        dispatch.record_launch("region_prep", shape=self.shape_key(
            k, b, x.element_size()))
        return out


def _launch(src, segptr, rowinfo, x, out, member_stride: int) -> None:
    """One launch of ``repro_region_prep``: ``out [R, B]`` from ``x`` read at
    ``x[g * member_stride + src * stride(0) + b * stride(1)]`` (element
    offsets from ``x``'s first element)."""
    lib = build.load()
    rs, cs = x.stride()
    with torch.cuda.device(x.device):
        code = lib.repro_region_prep(
            src.data_ptr(), segptr.data_ptr(),
            rowinfo.data_ptr(), x.data_ptr(),
            out.data_ptr(), out.shape[0], out.shape[1], member_stride, rs, cs,
            _BF16[x.dtype], torch.cuda.current_stream().cuda_stream)
    dispatch.check_launch(code, "repro_region_prep")


def cluster_segment_sum(labels: torch.Tensor, x: torch.Tensor,
                        num_clusters: int) -> torch.Tensor:
    """agg[C, B] = segment_sum(x[K, B], labels[K]).

    CUDA tensors take one region-prep launch of a single weight-shared
    member that keeps every row (its table made from ``labels`` on the host
    at every call); CPU tensors take :func:`cluster_segment_sum_plain`."""
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"expected x [K, B] and labels [K], got "
                         f"{tuple(x.shape)} and {tuple(labels.shape)}")
    if not dispatch.on_device(x):
        return cluster_segment_sum_plain(labels, x, num_clusters)
    return RegionPrep([(np.arange(x.shape[0]), labels.cpu().numpy(),
                        num_clusters)])(x)
