"""Production meshes and the hardware constants of the dry run's roofline
(counterpart of ``repro.launch.mesh``).

The meshes are abstract (:class:`~repro_torch.distributed.device_mesh
.AbstractMesh`): the reference's shapes and axis names, no processes, so a
256- or 512-card policy is computed in one process on the ``meta`` device.
"""
from __future__ import annotations

from repro_torch.distributed.device_mesh import AbstractMesh

__all__ = ["make_production_mesh", "HW"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 cards) or 2x16x16 (512 cards, 2 pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


class HW:
    """Per-card constants of the roofline: datasheet figures of the NVIDIA
    H100 80GB HBM3 (SXM5, 700 W), not measurements, and one assumption
    about the deployment (``NET_BW``)."""

    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor
    # core (the 1,979 TFLOP/s printed there is with 2:4 sparsity)
    PEAK_FLOPS_BF16 = 989e12  # FLOP/s
    # same datasheet, FP32 (outside the tensor cores)
    PEAK_FLOPS_F32 = 67e12  # FLOP/s
    # same datasheet, GPU memory bandwidth (HBM3)
    HBM_BW = 3.35e12  # B/s
    # same datasheet, GPU memory
    HBM_BYTES = 80 * 10**9
    # same datasheet, NVLink 900 GB/s bidirectional: 450 GB/s a direction,
    # between the cards of one HGX H100 8-GPU node
    NVLINK_BW = 450e9  # B/s
    NODE_CARDS = 8
    # an assumption about the deployment, not a datasheet figure: one
    # 400 Gb/s NDR InfiniBand adapter a card, for an axis whose group
    # spans more than one node
    NET_BW = 50e9  # B/s
